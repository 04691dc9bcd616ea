"""Attention over the dense KV caches: kernels and plain versions.

The int8 kernels replace the Pallas kernel
``protoquant_tpu/ops/attention.py:_attn_kernel`` for causal GQA with all
its variants; its plain version mirrors ``int8_kv_attention_xla`` of the
JAX package. The same sources, with their V layout switched to packed int4
token pairs, replace ``_attn_mixed_kernel`` (the K8V4 cache); its plain
version unpacks V and runs the int8 one, as the JAX test holds the Pallas
kernel. A call whose query rows a kv head fit one split block (every
decode), at any batch, takes the split-S design (``csrc/attn_split.cuh``,
merged by ``split_merge.cu``: blocks over fixed column ranges sized from
the capacity, dead ones exiting at once; :func:`attn_split_plan` asks the
library's plan; a windowed call's grid covers its window alone), any other
call (every prefill chunk) the flash prefill on bf16 tensor cores
(``csrc/attn_prefill.cuh``: 64 query rows a block, tiles of 64 keys (128
at Dh 128, 32 at Dh 256) wholly outside the rows' windows skipped, the TPU
kernel's bf16 lanes, with q in 1, 2 or 3 bf16 terms for bf16, f16 and f32
q (exact, exact, within 2^-25) and p * vs in 3 (within 2^-25)). The
wrappers count each route apart in ``.routes`` ("split", "prefill").
:func:`dense_attention_partials_ref` spells the split out in plain
PyTorch, :func:`dense_attention_tiles_ref` the prefill, for the tests.
The KIVI kernels replace ``_attn_k4v8_kernel`` and ``_attn4_kernel``: a
call whose query rows a kv head fit one split block and whose chunk G the
split tiles (every decode at G >= 8), at any batch, takes the split-S design
(``csrc/kivi_split.cuh``, ``split_merge.cu``: blocks over fixed key ranges
and the tail, partials merged in split order; :func:`kivi_split_plan` asks
the library's plan), any other call (every prefill chunk) the same flash
prefill on bf16 tensor cores as the int8 cache (``csrc/attn_prefill.cuh``
with ``KIVI``: the packed tiles up to the frontier, each K element the
nibble times its chunk-channel scale in 2 bf16 terms, then the tails' int8
tiles); their plain versions dequantize the cache to f32
(``dequant_fp(lane=f32)`` of the JAX caches) and run the int8 plain version
with unit scales, as the JAX tests hold the Pallas kernels.
:func:`kivi_attention_partials_ref` and :func:`merge_partials_ref` spell
out the split design's decomposition in plain PyTorch,
:func:`kivi_attention_tiles_ref` the prefill's, for the tests.
Variants, as the JAX functions take them: ``window`` > 0 hides keys more
than window - 1 positions behind each query, ``scale`` > 0 replaces the
score scale Dh^-0.5, ``softcap`` > 0 caps the scaled score to softcap *
tanh(score / softcap) before the mask, ``alibi_slopes`` [H] subtracts
slope_h * (query position - key position) after the cap, before the mask.
The int8 functions also take ``k_positions`` [B, S] int32, the absolute
position each column holds (a ring cache; negative = never written), and
``sinks``: with a window, positions below it stay visible (StreamingLLM).
The int8 and KIVI functions also take ``sink_logits`` [H] f32, GPT-OSS's
learned sinks: one logit per head joins every softmax and carries no value
(its probability mass is dropped); the kernels start each row's online
softmax from it (m0 = sink, l0 = 1, acc0 = 0), as the TPU kernels do.
The int8 and KIVI functions take window, scale, softcap, ALiBi and learned
sinks, the K8V4 ones ``scale`` alone (as ``mixed_kv_attention`` of the JAX
package), and the paged one ALiBi alone. Tree masks are not ported yet:
every function here raises ``NotImplementedError`` on them, and on a
variant the JAX function does not take.
With sinks over a contiguous cache (no ``k_positions``) the port keeps the
sink keys visible, as ``int8_kv_attention_xla`` does; the Pallas kernel
skips the tiles below the window and drops them (no JAX caller passes
sinks without positions).

The kernels and the plain versions place the score scale differently, as
in the JAX package: a kernel multiplies ``(q . k) * ks * sm`` (sm the
scale, or Dh^-0.5) after the dot, the plain version scales q before it. The
split kernels' outputs differ from the plain versions' by a few f32 ulps;
the prefill kernel's by its bf16 lanes (:func:`dense_attention_tiles_ref`).
"""

from __future__ import annotations

import ctypes

import torch

from ..core import numerics
from . import _build

NEG_INF = -1e30
_KERNEL_HEAD_DIMS = (32, 64, 128, 256)


def reject_variants(name, window=0, softcap=0.0, sink_logits=None, k_positions=None,
                     sinks=0, alibi_slopes=None, tree_mask=None):
    given = {"window": window != 0, "softcap": softcap != 0.0,
             "sink_logits": sink_logits is not None,
             "k_positions": k_positions is not None, "sinks": sinks != 0,
             "alibi_slopes": alibi_slopes is not None,
             "tree_mask": tree_mask is not None}
    used = [k for k, v in given.items() if v]
    if used:
        raise NotImplementedError(f"{name}: variant(s) {used} not ported")


def score_scale(head_dim: int, scale: float = 0.0) -> float:
    """The score multiplier: ``scale`` if > 0, else head_dim^-0.5."""
    return float(scale) if scale > 0.0 else head_dim**-0.5


def _window(name: str, window) -> int:
    if window < 0:
        raise ValueError(f"{name}: window {window} < 0")
    return int(window)


def _per_head(name, key, t, H):
    """Check a per-head operand ([H] f32, ``alibi_slopes`` or
    ``sink_logits``); return it as a list of the kernel's extra operands."""
    if t is None:
        return []
    if tuple(t.shape) != (H,):
        raise ValueError(f"{name}: {key} shape {tuple(t.shape)}, want ({H},)")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: {key} must be float32")
    return [t]


def softmax_with_sinks(scores, sink_logits, KV: int, group: int):
    """Softmax over the key axis of scores [B, KV, group, T, S], joined by
    one logit per head (``sink_logits`` [H], or None) whose probability is
    dropped, so a row's probabilities sum to less than 1
    (``protoquant_tpu/models/llama.py:_softmax_with_sinks``)."""
    if sink_logits is None:
        return torch.softmax(scores, dim=-1)
    sink = sink_logits.float().reshape(1, KV, group, 1, 1).expand(*scores.shape[:-1], 1)
    return torch.softmax(torch.cat([scores, sink], dim=-1), dim=-1)[..., :-1]


def int8_kv_attention_ref(q, kq, ks, vq, vs, lengths, window=0, scale=0.0, softcap=0.0,
                          k_positions=None, sinks=0, alibi_slopes=None, sink_logits=None,
                          **variants):
    """Plain version. q [B, T, H, Dh]; kq/vq [B, KV, S, Dh] int8 (already
    holding this step's tokens); ks/vs [B, KV, S] f32; lengths [B] = cache
    length before this step; ``window``, ``scale``, ``softcap``,
    ``k_positions``, ``sinks``, ``alibi_slopes``, ``sink_logits`` as the
    module says (the JAX package's ``int8_kv_attention_xla``). Returns [B,
    T, H, Dh] in q.dtype."""
    reject_variants("int8_kv_attention_ref", **variants)
    window = _window("int8_kv_attention_ref", window)
    B, T, H, Dh = q.shape
    KV, S = kq.shape[1], kq.shape[2]
    group = H // KV
    _per_head("int8_kv_attention_ref", "alibi_slopes", alibi_slopes, H)
    _per_head("int8_kv_attention_ref", "sink_logits", sink_logits, H)
    qh = (q.float() * score_scale(Dh, scale)).reshape(B, T, KV, group, Dh)
    scores = torch.einsum("btkgd,bksd->bkgts", qh, kq.float())
    scores = scores * ks[:, :, None, None, :]
    if softcap > 0.0:
        scores = softcap * torch.tanh(scores / softcap)
    t_pos = lengths.long()[:, None] + torch.arange(T, device=q.device)[None, :]  # [B, T]
    if k_positions is None:
        s_pos = torch.arange(S, device=q.device)[None, :].expand(B, S)
    else:
        s_pos = k_positions.long()
    if alibi_slopes is not None:
        dist = (t_pos[:, :, None] - s_pos[:, None, :]).float()  # [B, T, S]
        sl = alibi_slopes.float().reshape(KV, group)
        scores = scores - sl[None, :, :, None, None] * dist[:, None, None]
    kp = s_pos[:, None, None, None, :]
    qp = t_pos[:, None, None, :, None]
    mask = (kp <= qp) & (kp >= 0)
    if window > 0:
        in_window = kp > qp - window
        if sinks > 0:
            in_window |= kp < sinks
        mask &= in_window
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = softmax_with_sinks(scores, sink_logits, KV, group)
    pv = probs * vs[:, :, None, None, :]
    out = torch.einsum("bkgts,bksd->btkgd", pv, vq.float())
    return out.reshape(B, T, H, Dh).to(q.dtype)


def _dense_attention_launch(name, fn, v4, q, kq, ks, vq, vs, lengths, scale=0.0, window=0,
                            softcap=0.0, k_positions=None, sinks=0, alibi_slopes=None,
                            sink_logits=None):
    """Check the operands of the dense attention kernels (V int8 per token,
    or with ``v4`` packed token pairs and parity-split scales, which take
    the score scale alone), launch the split decode or the prefill kernel as
    :func:`attn_split_plan` decides and count the call on ``fn`` and its
    route."""
    B, T, H, Dh = q.shape
    KV, S = kq.shape[1], kq.shape[2]
    v_shape = ((B, KV, S // 2, Dh), (B, KV, 2, S // 2)) if v4 else ((B, KV, S, Dh), (B, KV, S))
    if H % KV or kq.shape != (B, KV, S, Dh) or vq.shape != v_shape[0] or (v4 and S % 2):
        raise ValueError(f"{name}: q {tuple(q.shape)} vs cache "
                         f"{tuple(kq.shape)} / {tuple(vq.shape)}")
    if ks.shape != (B, KV, S) or vs.shape != v_shape[1] or lengths.shape != (B,):
        raise ValueError(f"{name}: scale or length shapes")
    if Dh not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {Dh} not in {_KERNEL_HEAD_DIMS}")
    if q.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"{name}: unsupported dtype {q.dtype}")
    if kq.dtype != torch.int8 or vq.dtype != torch.int8:
        raise TypeError(f"{name}: cache payload must be int8")
    if ks.dtype != torch.float32 or vs.dtype != torch.float32:
        raise TypeError(f"{name}: cache scales must be float32")
    if lengths.dtype != torch.int32:
        raise TypeError(f"{name}: lengths must be int32")
    if sinks < 0:
        raise ValueError(f"{name}: sinks {sinks} < 0")
    extra = []
    if k_positions is not None:
        if tuple(k_positions.shape) != (B, S) or k_positions.dtype != torch.int32:
            raise ValueError(f"{name}: k_positions must be [B, S] = {(B, S)} int32, got "
                             f"{tuple(k_positions.shape)} {k_positions.dtype}")
        extra.append(k_positions)
    extra += _per_head(name, "alibi_slopes", alibi_slopes, H)
    extra += _per_head(name, "sink_logits", sink_logits, H)
    q = q.contiguous()
    dev = _build.same_device_contiguous(name, q, kq, ks, vq, vs, lengths, *extra)
    if kq.data_ptr() % 16 or vq.data_ptr() % 16:  # the kernels copy 16-byte rows
        raise ValueError(f"{name}: cache payloads must be 16-byte aligned")
    out = torch.empty_like(q)
    ptr = lambda t: None if t is None else t.data_ptr()
    c_name = "pq_mixed_kv_attention" if v4 else "pq_int8_kv_attention"
    head = (q.data_ptr(), _build.DTYPE_CODES[q.dtype], kq.data_ptr(), ks.data_ptr(),
            vq.data_ptr(), vs.data_ptr(), lengths.data_ptr())
    shape = (B, T, H, KV, S, Dh, score_scale(Dh, scale))
    if not v4:  # the variants the K8V4 entries do not take
        head += (ptr(k_positions), ptr(alibi_slopes), ptr(sink_logits))
        shape += (window, float(softcap), int(sinks))
    plan = attn_split_plan(T, H, KV, S, Dh, window, sinks, k_positions is not None)
    if plan is None:
        route = "prefill"
        err = getattr(_build.lib(), c_name)(*head, out.data_ptr(), *shape,
                                            _build.stream_ptr(dev))
    else:  # the partials' workspace, from PyTorch's allocator: nothing kept between calls
        route, c_name = "split", c_name + "_split"
        n_split = plan[1]
        R = T * (H // KV)
        part_acc = torch.empty(B, KV, n_split, R, Dh, dtype=torch.float32, device=dev)
        part_ml = torch.empty(B, KV, n_split, R, 2, dtype=torch.float32, device=dev)
        err = getattr(_build.lib(), c_name)(*head, out.data_ptr(), part_acc.data_ptr(),
                                            part_ml.data_ptr(), *shape, n_split,
                                            _build.stream_ptr(dev))
    _build.check(err, c_name)
    fn.launches += 1
    fn.routes[route] += 1
    return out


def attn_split_plan(T, H, KV, S, head_dim, window=0, sinks=0, ring=False):
    """(span, n_split) of the split-S decode for an int8 or K8V4 attention
    call, or None where the prefill kernel takes it, as ``as_plan`` in
    ``csrc/attn_split.cuh`` decides (asked through the built library): the
    columns of a split and the number of splits (over the capacity S, or
    over the window of a windowed call without ring positions (``ring``)
    and StreamingLLM ``sinks``; there the kernel may take a longer span
    when the batch's rows keep more splits live than one wave of the card
    holds, so that the partials fill fewer of the n_split slots)."""
    span = ctypes.c_int(0)
    n_split = _build.lib().pq_attn_split_plan(T, H, KV, S, head_dim, int(window), int(sinks),
                                              int(ring), ctypes.byref(span))
    return (span.value, n_split) if n_split else None


def dense_attention_partials_ref(q, kq, ks, vq, vs, lengths, *, span, v4=False, window=0,
                                 scale=0.0, softcap=0.0, k_positions=None, sinks=0,
                                 alibi_slopes=None):
    """The split design of the int8 and K8V4 attentions in plain PyTorch:
    for each (b, kv head), split i holds the columns [i span, (i + 1) span)
    of the capacity S (the kernel's span is :func:`attn_split_plan`'s),
    n_split = ceil(S / span); with ``v4`` the cache is K8V4's (V unpacked by
    :func:`unpack_v4`). Every variant applies per column as in
    :func:`int8_kv_attention_ref`: the window, the score scale, the softcap,
    the ring positions ``k_positions``, the StreamingLLM ``sinks`` and ALiBi
    after the softcap. Per split and query row r = t group + g: m = the
    largest visible score, l = sum e^(score - m), acc = sum e^(score - m)
    vs v; a split with no visible key is empty (m = NEG_INF, l = 0, acc =
    0). Returns acc [B, KV, n_split, R, Dh], m and l [B, KV, n_split, R],
    f32. The learned sinks join in :func:`merge_partials_ref`."""
    if v4:
        vq, vs = unpack_v4(vq, vs)
    window = _window("dense_attention_partials_ref", window)
    B, T, H, Dh = q.shape
    KV, S = kq.shape[1], kq.shape[2]
    grp, R = H // KV, T * (H // KV)
    n_split = -(-S // span)
    qh = (q.float() * score_scale(Dh, scale)).reshape(B, T, KV, grp, Dh)
    scores = torch.einsum("btkgd,bksd->bktgs", qh, kq.float()).reshape(B, KV, R, S)
    scores = scores * ks[:, :, None, :]
    if softcap > 0.0:
        scores = softcap * torch.tanh(scores / softcap)
    t_pos = (lengths.long()[:, None] + torch.arange(T, device=q.device))[:, None, :, None]
    t_pos = t_pos.expand(B, 1, T, grp).reshape(B, 1, R, 1)
    if k_positions is None:
        kp = torch.arange(S, device=q.device)[None, None, None, :]
    else:
        kp = k_positions.long()[:, None, None, :]  # [B, 1, 1, S]
    if alibi_slopes is not None:
        sl = alibi_slopes.float().reshape(KV, grp).repeat(1, T)  # [KV, R]
        scores = scores - sl[None, :, :, None] * (t_pos - kp).float()
    valid = (kp <= t_pos) & (kp >= 0)
    if window > 0:
        in_window = kp > t_pos - window
        if sinks > 0:
            in_window |= kp < sinks
        valid &= in_window
    cols = torch.arange(S, device=q.device)
    member = (cols[:, None] // span) == torch.arange(n_split, device=q.device)  # [S, n_split]
    live = valid[..., None] & member  # [B, KV, R, S, n_split]
    m = torch.where(live, scores[..., None], NEG_INF).amax(dim=3)  # [B, KV, R, n_split]
    p = torch.where(live, torch.exp(scores[..., None] - m[:, :, :, None]), 0.0)
    acc = torch.einsum("bkrsn,bksd->bknrd", p * vs[:, :, None, :, None], vq.float())
    return acc, m.transpose(2, 3), p.sum(dim=3).transpose(2, 3)


PREFILL_ROWS = 64  # query rows of a prefill block (AP_ROWS in csrc/attn_prefill.cuh)
KIVI_K_TERMS = 2  # bf16 terms of a KIVI packed K element (ApGeom::NK in csrc/attn_prefill.cuh)


def prefill_key_tile(head_dim: int) -> int:
    """Keys of a prefill tile (``ApGeom::KT`` in ``csrc/attn_prefill.cuh``)."""
    return {128: 128, 256: 32}.get(head_dim, 64)


def prefill_terms(dtype) -> tuple:
    """(q, p * vs) bf16 terms the prefill kernel splits its operands into for
    q of ``dtype`` (``ApTerms``): (1, 3) for bf16, (2, 3) for f16, (3, 3)
    for f32."""
    return {torch.bfloat16: (1, 3), torch.float16: (2, 3)}.get(dtype, (3, 3))


def _bf16_terms(x, n: int) -> list:
    """f32 x as n bf16 values (in f32), each the rounded remainder of x
    after the ones before it."""
    terms = []
    for _ in range(n):
        terms.append(x.to(torch.bfloat16).float())
        x = x - terms[-1]
    return terms


def dense_attention_tiles_ref(q, kq, ks, vq, vs, lengths, *, v4=False, lane=torch.bfloat16,
                              terms=None, k_terms=0, window=0, scale=0.0, softcap=0.0,
                              k_positions=None, sinks=0, alibi_slopes=None, sink_logits=None):
    """The prefill kernel of the int8 and K8V4 attentions
    (``csrc/attn_prefill.cuh``) in plain PyTorch, with its walk, its tiles
    and its lanes; the contract is :func:`int8_kv_attention_ref`'s (with
    ``v4`` the cache is K8V4's, V unpacked by :func:`unpack_v4`).
    Query rows r = t group + g of a kv head go in blocks of
    :data:`PREFILL_ROWS`; a block walks the tiles of
    :func:`prefill_key_tile` keys from the one holding its first row's
    earliest visible key (with a window over a contiguous cache; else 0) to
    its last row's horizon min(S, lengths + t_last + 1), and, with
    StreamingLLM sinks, the tiles holding columns < sinks; a ring
    (``k_positions``) walks every tile. A key outside the walk is dropped.
    Per tile, in column order, each row's online softmax: m' = max(m, the
    tile's largest visible score), l = l e^(m - m') + sum p, acc = acc e^(m -
    m') + (p vs) . v with p = e^(score - m') where visible, else 0; m starts
    at the learned sink (``sink_logits``) with l = 1, else at NEG_INF with l
    = 0; out = acc / max(l, 1e-30). ``lane``: torch.float32 computes the
    dots in f32; torch.bfloat16 takes them as the kernel does, q and p * vs
    as bf16 terms against the exact bf16 k and v, summed in f32: ``terms``
    (q's, p * vs's), or one count for both (1: the TPU kernel's lanes);
    None: the kernel's, :func:`prefill_terms` of q's dtype. ``k_terms`` > 0
    splits k (f32 values, as :func:`kivi_attention_tiles_ref` passes) into
    that many bf16 terms too, each q term meeting each k term; 0 takes k as
    given (int8 codes: exact). Returns [B, T, H, Dh] in q.dtype."""
    if v4:
        vq, vs = unpack_v4(vq, vs)
    window = _window("dense_attention_tiles_ref", window)
    B, T, H, Dh = q.shape
    KV, S = kq.shape[1], kq.shape[2]
    grp, R = H // KV, T * (H // KV)
    KT, dev = prefill_key_tile(Dh), q.device
    nq, np_ = prefill_terms(q.dtype) if terms is None else (
        (terms, terms) if isinstance(terms, int) else terms)
    if lane == torch.float32:
        nq = np_ = k_terms = 0
    split = lambda x, n: _bf16_terms(x, n) if n else [x]
    q_terms = split(q.float().reshape(B, T, KV, grp, Dh).transpose(1, 2).reshape(B, KV, R, Dh),
                    nq)
    k_parts, v = split(kq.float(), k_terms), vq.float()
    ln = lengths.long()[:, None]
    limit = ln + torch.arange(R, device=dev) // grp  # [B, R]: each row's position
    # each row block's walk over the tiles [B, blocks, tiles], as the kernel's
    first = torch.arange(0, R, PREFILL_ROWS, device=dev)
    last = (first + PREFILL_ROWS).clamp_max(R) - 1
    ring = k_positions is not None
    zero = torch.zeros(B, first.numel(), dtype=torch.long, device=dev)
    n_keys = zero + S if ring else (ln + last // grp + 1).clamp(0, S)
    skip = window > 0 and not ring
    c_start = ((ln + first // grp - window + 1).clamp_min(0) // KT) * KT if skip else zero
    c_sink = n_keys.clamp_max(sinks) if skip else zero
    c0 = torch.arange(0, S, KT, device=dev)
    walked = (c0 < n_keys[..., None]) & ((c0 >= c_start[..., None]) | (c0 < c_sink[..., None]))
    walked = walked.repeat_interleave(KT, dim=2)[:, torch.arange(R, device=dev) // PREFILL_ROWS,
                                                 :S]  # [B, R, S]
    pos = (k_positions.long() if ring else torch.arange(S, device=dev).expand(B, S))[:, None]
    lim = limit[:, :, None]
    valid = (pos >= 0) & (pos <= lim) & walked
    if window > 0:
        valid &= (pos > lim - window) | (pos < sinks)
    valid = valid[:, None]  # [B, 1, R, S]
    dist = (lim - pos).float()[:, None]
    per_row = lambda x: x.float().reshape(KV, grp).repeat(1, T)[None]  # [H] -> [1, KV, R]
    if sink_logits is None:
        m = torch.full((B, KV, R), NEG_INF, device=dev)
        l = torch.zeros(B, KV, R, device=dev)
    else:
        m = per_row(sink_logits).expand(B, KV, R).clone()
        l = torch.ones(B, KV, R, device=dev)
    acc = torch.zeros(B, KV, R, Dh, device=dev)
    sm = score_scale(Dh, scale)
    for c in range(0, S, KT):
        cols = slice(c, min(c + KT, S))
        s = sum(torch.einsum("bkrd,bksd->bkrs", qt, kt[:, :, cols])
                for qt in q_terms for kt in k_parts)
        s = s * ks[:, :, None, cols] * sm
        if softcap > 0.0:
            s = softcap * torch.tanh(s * (1.0 / softcap))
        if alibi_slopes is not None:
            s = s - per_row(alibi_slopes)[..., None] * dist[..., cols]
        vis = valid[..., cols]
        m_new = torch.maximum(m, torch.where(vis, s, NEG_INF).amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.where(vis, torch.exp(s - m_new[..., None]), 0.0)
        l = l * corr + p.sum(dim=-1)
        pvs = torch.where(vis, p * vs[:, :, None, cols], 0.0)
        acc = acc * corr[..., None] + sum(torch.einsum("bkrs,bksd->bkrd", pt, v[:, :, cols])
                                          for pt in split(pvs, np_))
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.reshape(B, KV, T, grp, Dh).transpose(1, 2).reshape(B, T, H, Dh).to(q.dtype)


def int8_kv_attention(q, kq, ks, vq, vs, lengths, window=0, scale=0.0, softcap=0.0,
                      k_positions=None, sinks=0, alibi_slopes=None, sink_logits=None,
                      **variants):
    """Causal GQA attention over the int8 cache, with its sliding window,
    score scale, softcap, ring positions, StreamingLLM sinks, ALiBi and
    learned sinks; same contract as :func:`int8_kv_attention_ref`. Returns
    [B, T, H, Dh] in q.dtype."""
    reject_variants("int8_kv_attention", **variants)
    window = _window("int8_kv_attention", window)
    kw = dict(window=window, scale=scale, softcap=softcap, k_positions=k_positions,
              sinks=sinks, alibi_slopes=alibi_slopes, sink_logits=sink_logits)
    if q.device.type == "cpu":
        return int8_kv_attention_ref(q, kq, ks, vq, vs, lengths, **kw)
    return _dense_attention_launch("int8_kv_attention", int8_kv_attention, False,
                                   q, kq, ks, vq, vs, lengths, **kw)


int8_kv_attention.launches = 0
# launches by kernel: "split" (attn_split.cuh and the merge), "prefill"
# (attn_prefill.cuh)
int8_kv_attention.routes = {"split": 0, "prefill": 0}


# -- mixed K8V4 cache: int8 K per token, packed int4 V per token -----------------


def unpack_v4(vq, vs):
    """Packed V [B, KV, S/2, Dh] and parity-split scales vs [B, KV, 2, S/2]
    -> per-token nibble values [B, KV, S, Dh] int8 and scales [B, KV, S]
    (``MixedKVCache._unpack_v`` of the JAX package)."""
    B, KV, S2, _ = vq.shape
    return _unpack_tokens(vq).to(torch.int8), vs.transpose(2, 3).reshape(B, KV, 2 * S2)


def mixed_kv_attention_ref(q, kq, ks, vq, vs, lengths, scale=0.0, **variants):
    """Plain version of :func:`mixed_kv_attention`: V unpacked to per-token
    nibbles and scales, then :func:`int8_kv_attention_ref`."""
    reject_variants("mixed_kv_attention_ref", **variants)
    return int8_kv_attention_ref(q, kq, ks, *unpack_v4(vq, vs), lengths, scale=scale)


def mixed_kv_attention(q, kq, ks, vq, vs, lengths, scale=0.0, **variants):
    """Causal GQA attention over the K8V4 cache, prefill (T > 1) or decode.

    q [B, T, H, Dh]; kq [B, KV, S, Dh] int8 and ks [B, KV, S] f32 as the
    int8 cache; vq [B, KV, S/2, Dh] int8 packed token pairs (row r: token
    2r in the low nibble, 2r + 1 in the high one), vs [B, KV, 2, S/2] f32
    per-token scales (plane 0 even tokens, plane 1 odd); lengths [B] int32 =
    length before this step. Query t sees keys p <= lengths + t; ``scale``
    > 0 replaces the score scale Dh^-0.5. Returns [B, T, H, Dh] in q.dtype.
    Replaces ``protoquant_tpu/ops/attention.py:mixed_kv_attention``
    (``_attn_mixed_kernel``), full-causal as it is.
    """
    reject_variants("mixed_kv_attention", **variants)
    if q.device.type == "cpu":
        return mixed_kv_attention_ref(q, kq, ks, vq, vs, lengths, scale)
    return _dense_attention_launch("mixed_kv_attention", mixed_kv_attention, True,
                                   q, kq, ks, vq, vs, lengths, scale)


mixed_kv_attention.launches = 0
mixed_kv_attention.routes = {"split": 0, "prefill": 0}


# -- KIVI caches: K4V8 (int4 K, int8 V) and Int4 (int4 K and V) ----------------


def _unpack_tokens(packed):
    """Packed token pairs [B, KV, S/2, Dh] -> nibble values [B, KV, S, Dh]
    (row r holds token 2r in its low nibble, 2r + 1 in its high one)."""
    B, KV, S2, Dh = packed.shape
    lo, hi = numerics.unpack_nib_pair(packed)
    return torch.stack([lo, hi], dim=3).reshape(B, KV, 2 * S2, Dh)


def _tail_overlay(x_fp, tail, ts, lengths, group):
    """Positions [F, F + 2G) of x_fp [B, KV, S, Dh] (F = (lengths // G) G)
    replaced by tail row pos mod 2G times its scale, in f32."""
    B, KV, S, Dh = x_fp.shape
    pos = torch.arange(S, device=x_fp.device)
    F = (lengths.long() // group) * group
    rel = pos[None, :] - F[:, None]
    in_tail = (rel >= 0) & (rel < 2 * group)
    row = pos % (2 * group)
    t = tail[:, :, row].float() * ts[:, :, row][..., None]
    return torch.where(in_tail[:, None, :, None], t, x_fp)


def kivi_dequant_k(kq, kchs, ktail, kts, lengths, group):
    """f32 keys [B, KV, S, Dh] of a KIVI cache whose length is ``lengths``:
    nibble times its chunk-channel scale below the frontier, the int8 tail
    row times its scale from it (``K4V8KVCache.dequant_fp(lane=f32)``'s K)."""
    nib = _unpack_tokens(kq)
    S = nib.shape[2]
    ksc = kchs[:, :, torch.arange(S, device=kq.device) // group]
    return _tail_overlay(nib.float() * ksc, ktail, kts, lengths, group)


def kivi_dequant_v4(vq, vs, vtail, vts, lengths, group):
    """f32 values [B, KV, S, Dh] of the Int4 cache (per-token scales from
    the parity-split vs [B, KV, 2, S/2]), tail overlaid as for K."""
    nib = _unpack_tokens(vq)
    B, KV, S, Dh = nib.shape
    vsc = vs.transpose(2, 3).reshape(B, KV, S)
    return _tail_overlay(nib.float() * vsc[..., None], vtail, vts, lengths, group)


def _kivi_ref(name, q, k_fp, v_fp, lengths, window, scale, softcap, alibi_slopes,
              sink_logits, variants):
    reject_variants(name, **variants)
    ones = torch.ones(k_fp.shape[:3], dtype=torch.float32, device=k_fp.device)
    return int8_kv_attention_ref(q, k_fp, ones, v_fp, ones, lengths, window, scale, softcap,
                                 alibi_slopes=alibi_slopes, sink_logits=sink_logits)


def k4v8_attention_ref(q, kq, kchs, vq, vs, ktail, kts, vtail, vts, lengths,
                       new_lengths, *, group, window=0, scale=0.0, softcap=0.0,
                       alibi_slopes=None, sink_logits=None, **variants):
    """Plain version of :func:`k4v8_attention`: the cache dequantized to f32
    at ``new_lengths`` (V from the int8 store), then
    :func:`int8_kv_attention_ref` with unit scales and the same variants, as
    the JAX tests hold the Pallas kernel."""
    k_fp = kivi_dequant_k(kq, kchs, ktail, kts, new_lengths, group)
    v_fp = vq.float() * vs[..., None]
    return _kivi_ref("k4v8_attention_ref", q, k_fp, v_fp, lengths, window, scale, softcap,
                     alibi_slopes, sink_logits, variants)


def int4_kv_attention_ref(q, kq, kchs, vq, vs, ktail, kts, vtail, vts, lengths,
                          new_lengths, *, group, window=0, scale=0.0, softcap=0.0,
                          alibi_slopes=None, sink_logits=None, **variants):
    """Plain version of :func:`int4_kv_attention` (as
    :func:`k4v8_attention_ref`, V from the packed store and the V tail)."""
    k_fp = kivi_dequant_k(kq, kchs, ktail, kts, new_lengths, group)
    v_fp = kivi_dequant_v4(vq, vs, vtail, vts, new_lengths, group)
    return _kivi_ref("int4_kv_attention_ref", q, k_fp, v_fp, lengths, window, scale, softcap,
                     alibi_slopes, sink_logits, variants)


def kivi_attention_tiles_ref(q, kq, kchs, vq, vs, ktail, kts, vtail, vts, lengths,
                             new_lengths, *, group, v4, lane=torch.bfloat16, terms=None,
                             window=0, scale=0.0, softcap=0.0, alibi_slopes=None,
                             sink_logits=None):
    """The prefill kernel of the KIVI attentions (``csrc/attn_prefill.cuh``
    with ``KIVI``; V4: Int4) in plain PyTorch: its walk laid out as the
    columns of a dense cache for :func:`dense_attention_tiles_ref`, whose
    blocks, tiles, online softmax and lanes it takes. Columns [0, S) hold the
    packed store, K = nib * kchs[p // G] (the plain version's f32 products),
    V int8 (K4V8) or the nibbles (Int4) with their per-token scales, visible
    below the frontier F = (min(new_lengths, S) // G) G; from S rounded up to
    the key tile follow the tails' 2G rows (K and V int8 with their scales),
    tail column c holding the one position = c mod 2G in [F, F + 2G),
    visible below S; every column then as the contract says (causal, the
    window, ALiBi after the softcap, the learned sinks). A walk over every
    tile drops no key the kernel's walk keeps and adds only tiles a row
    sees nothing of, which leave its state as it was. ``lane`` and
    ``terms`` as :func:`dense_attention_tiles_ref`; at ``lane`` bf16 a K
    element is split into :data:`KIVI_K_TERMS` bf16 terms (the tails' int8
    codes are exact in the first). Returns [B, T, H, Dh] in q.dtype."""
    B, T, H, Dh = q.shape
    KV, S = kq.shape[1], 2 * kq.shape[2]
    TC, KT, dev = 2 * group, prefill_key_tile(Dh), q.device
    Sp, TCp = -(-S // KT) * KT, -(-TC // KT) * KT
    cols = lambda x, n: torch.nn.functional.pad(x, (0, 0, 0, n - x.shape[2]) if x.dim() == 4
                                                else (0, n - x.shape[2]))
    k_packed = _unpack_tokens(kq).float() * kchs[:, :, torch.arange(S, device=dev) // group]
    v_packed, vs_packed = unpack_v4(vq, vs) if v4 else (vq, vs)
    k = torch.cat([cols(k_packed, Sp), cols(ktail.float(), TCp)], dim=2)
    ks = torch.cat([torch.ones(B, KV, Sp, device=dev), cols(kts, TCp)], dim=2)
    v = torch.cat([cols(v_packed.float(), Sp), cols(vtail.float(), TCp)], dim=2)
    vsc = torch.cat([cols(vs_packed, Sp), cols(vts, TCp)], dim=2)
    F = ((new_lengths.long().clamp(0, S) // group) * group)[:, None]  # [B, 1]
    c, j = torch.arange(Sp, device=dev), torch.arange(TCp, device=dev)
    f_mod = F % TC
    p = F - f_mod + j + torch.where(j < f_mod, TC, 0)
    k_positions = torch.cat([torch.where(c < F, c, -1),
                             torch.where((j < TC) & (p < S), p, -1)], dim=1).int()
    return dense_attention_tiles_ref(
        q, k, ks, v, vsc, lengths, lane=lane, terms=terms, k_terms=KIVI_K_TERMS, window=window,
        scale=scale, softcap=softcap, k_positions=k_positions, alibi_slopes=alibi_slopes,
        sink_logits=sink_logits)


def kivi_split_plan(T, H, KV, S, head_dim, group):
    """(span, n_split) of the split-S decode for a KIVI attention call, or
    None where the prefill kernel takes it, as ``ks_plan`` in
    ``csrc/kivi_split.cuh`` decides (asked through the built library): the
    packed keys of a split and the number of splits, the packed ones over
    the capacity S and the tail's."""
    span = ctypes.c_int(0)
    n_split = _build.lib().pq_kivi_split_plan(T, H, KV, S, head_dim, group, ctypes.byref(span))
    return (span.value, n_split) if n_split else None


def kivi_attention_partials_ref(q, kq, kchs, vq, vs, ktail, kts, vtail, vts, lengths,
                                new_lengths, *, group, v4, span, window=0, scale=0.0,
                                softcap=0.0, alibi_slopes=None):
    """The split design's partials in plain PyTorch: for each (b, kv head),
    split i < n_split - 1 holds the packed keys [i span, (i + 1) span)
    (``span`` a multiple of G; the kernel's is :func:`kivi_split_plan`'s) below
    the frontier F = (min(new_lengths, S) // G) G, the last split the
    positions from F (the tails, V from the tail mirror for K4V8 too, as the
    kernel reads it), n_split = ceil(S / span) + 1. Per split and query row
    r = t group + g: m = the largest visible score, l = sum e^(score - m),
    acc = sum e^(score - m) v; a split with no visible key is empty (m =
    NEG_INF, l = 0, acc = 0). Returns acc [B, KV, n_split, R, Dh], m and l
    [B, KV, n_split, R], f32. The learned sinks join in
    :func:`merge_partials_ref`."""
    B, T, H, Dh = q.shape
    KV, S = kq.shape[1], 2 * kq.shape[2]
    grp, R = H // KV, T * (H // KV)
    n_split = -(-S // span) + 1
    k_fp = kivi_dequant_k(kq, kchs, ktail, kts, new_lengths, group)
    v_fp = (kivi_dequant_v4(vq, vs, vtail, vts, new_lengths, group) if v4 else
            _tail_overlay(vq.float() * vs[..., None], vtail, vts, new_lengths, group))
    qh = (q.float() * score_scale(Dh, scale)).reshape(B, T, KV, grp, Dh)
    scores = torch.einsum("btkgd,bksd->bktgs", qh, k_fp).reshape(B, KV, R, S)
    if softcap > 0.0:
        scores = softcap * torch.tanh(scores / softcap)
    pos = torch.arange(S, device=q.device)
    t_pos = (lengths.long()[:, None] + torch.arange(T, device=q.device))[:, None, :, None]
    t_pos = t_pos.expand(B, 1, T, grp).reshape(B, 1, R, 1)
    if alibi_slopes is not None:
        sl = alibi_slopes.float().reshape(KV, grp).repeat(1, T)  # [KV, R]
        scores = scores - sl[None, :, :, None] * (t_pos - pos).float()
    valid = pos <= t_pos
    if window > 0:
        valid &= pos > t_pos - window
    frontier = (new_lengths.long().clamp(0, S) // group) * group
    split_of = torch.where(pos < frontier[:, None], pos // span, n_split - 1)  # [B, S]
    member = (split_of[..., None] == torch.arange(n_split, device=q.device))[:, None, None]
    live = valid[..., None] & member  # [B, KV, R, S, n_split]
    m = torch.where(live, scores[..., None], NEG_INF).amax(dim=3)  # [B, KV, R, n_split]
    p = torch.where(live, torch.exp(scores[..., None] - m[:, :, :, None]), 0.0)
    acc = torch.einsum("bkrsn,bksd->bknrd", p, v_fp)
    return acc, m.transpose(2, 3), p.sum(dim=3).transpose(2, 3)


def merge_partials_ref(acc, m, l, heads, sink_logits=None, dtype=torch.float32):
    """The merge of :func:`kivi_attention_partials_ref`'s or
    :func:`dense_attention_partials_ref`'s partials in split order, the
    learned sink (``sink_logits`` [heads]) joining once as the state m =
    sink, l = 1, acc = 0: M = max(sink, m_i over the splits with l_i > 0),
    out = sum_i acc_i e^(m_i - M) / (e^(sink - M) + sum_i l_i e^(m_i - M)).
    Returns [B, T, heads, Dh] in ``dtype``."""
    B, KV, _, R, Dh = acc.shape
    grp = heads // KV
    live = l > 0
    M = torch.where(live, m, NEG_INF).amax(dim=2)  # [B, KV, R]
    if sink_logits is not None:
        sink = sink_logits.float().reshape(KV, grp).repeat(1, R // grp)[None]  # [1, KV, R]
        M = torch.maximum(M, sink)
    w = torch.where(live, torch.exp(m - M[:, :, None]), 0.0)  # [B, KV, n_split, R]
    L = (l * w).sum(dim=2)
    if sink_logits is not None:
        L = L + torch.exp(sink - M)
    out = (acc * w[..., None]).sum(dim=2) / L.clamp_min(1e-30)[..., None]  # [B, KV, R, Dh]
    out = out.reshape(B, KV, R // grp, grp, Dh).permute(0, 2, 1, 3, 4)
    return out.reshape(B, R // grp, heads, Dh).to(dtype)


def _kivi_attention_launch(name, fn, v4, q, kq, kchs, vq, vs, ktail, kts, vtail,
                           vts, lengths, new_lengths, group, window, scale, softcap,
                           alibi_slopes, sink_logits):
    B, T, H, Dh = q.shape
    KV, S2 = kq.shape[1], kq.shape[2]
    S, G = 2 * S2, group
    if H % KV:
        raise ValueError(f"{name}: {H} heads over {KV} kv heads")
    if G < 2 or G % 2 or S % G:
        raise ValueError(f"{name}: group {G} must be even and divide max_seq {S}")
    if Dh not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {Dh} not in {_KERNEL_HEAD_DIMS}")
    v_shape = ((B, KV, S2, Dh), (B, KV, 2, S2)) if v4 else ((B, KV, S, Dh), (B, KV, S))
    shapes = {"kq": (kq, (B, KV, S2, Dh)), "kchs": (kchs, (B, KV, S // G, Dh)),
              "vq": (vq, v_shape[0]), "vs": (vs, v_shape[1]),
              "ktail": (ktail, (B, KV, 2 * G, Dh)), "kts": (kts, (B, KV, 2 * G)),
              "vtail": (vtail, (B, KV, 2 * G, Dh)), "vts": (vts, (B, KV, 2 * G)),
              "lengths": (lengths, (B,)), "new_lengths": (new_lengths, (B,))}
    for key, (t, want) in shapes.items():
        if tuple(t.shape) != want:
            raise ValueError(f"{name}: {key} shape {tuple(t.shape)}, want {want}")
    if q.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"{name}: unsupported dtype {q.dtype}")
    for t in (kq, vq, ktail, vtail):
        if t.dtype != torch.int8:
            raise TypeError(f"{name}: cache payload must be int8")
    for t in (kchs, vs, kts, vts):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: cache scales must be float32")
    if lengths.dtype != torch.int32 or new_lengths.dtype != torch.int32:
        raise TypeError(f"{name}: lengths must be int32")
    extra = (_per_head(name, "alibi_slopes", alibi_slopes, H)
             + _per_head(name, "sink_logits", sink_logits, H))
    q = q.contiguous()
    dev = _build.same_device_contiguous(name, q, kq, kchs, vq, vs, ktail, kts, vtail,
                                        vts, lengths, new_lengths, *extra)
    if any(t.data_ptr() % 16 for t in (kq, kchs, vq, ktail, vtail)):  # 16-byte copies
        raise ValueError(f"{name}: cache payloads and K scales must be 16-byte aligned")
    out = torch.empty_like(q)
    c_name = "pq_int4_kv_attention" if v4 else "pq_k4v8_attention"
    ptr = lambda t: None if t is None else t.data_ptr()
    args = (q.data_ptr(), _build.DTYPE_CODES[q.dtype], kq.data_ptr(), kchs.data_ptr(),
            vq.data_ptr(), vs.data_ptr(), ktail.data_ptr(), kts.data_ptr(), vtail.data_ptr(),
            vts.data_ptr(), lengths.data_ptr(), new_lengths.data_ptr(), ptr(alibi_slopes),
            ptr(sink_logits), out.data_ptr())
    shape = (B, T, H, KV, S, Dh, G, score_scale(Dh, scale), window, float(softcap))
    plan = kivi_split_plan(T, H, KV, S, Dh, G)
    if plan is None:
        route = "prefill"
        err = getattr(_build.lib(), c_name)(*args, *shape, _build.stream_ptr(dev))
    else:  # the partials' workspace, from PyTorch's allocator: nothing kept between calls
        route, c_name = "split", c_name + "_split"
        n_split = plan[1]
        R = T * (H // KV)
        part_acc = torch.empty(B, KV, n_split, R, Dh, dtype=torch.float32, device=dev)
        part_ml = torch.empty(B, KV, n_split, R, 2, dtype=torch.float32, device=dev)
        err = getattr(_build.lib(), c_name)(*args, part_acc.data_ptr(), part_ml.data_ptr(),
                                            *shape, n_split, _build.stream_ptr(dev))
    _build.check(err, c_name)
    fn.launches += 1
    fn.routes[route] += 1
    return out


def k4v8_attention(q, kq, kchs, vq, vs, ktail, kts, vtail, vts, lengths,
                   new_lengths, *, group, window=0, scale=0.0, softcap=0.0, alibi_slopes=None,
                   sink_logits=None, **variants):
    """Causal GQA attention over the K4V8 cache, prefill (T > 1) or decode.

    q [B, T, H, Dh]; kq [B, KV, S/2, Dh] packed int4 K; kchs [B, KV, S/G,
    Dh] f32; vq [B, KV, S, Dh] int8; vs [B, KV, S] f32; ktail/vtail [B, KV,
    2G, Dh] int8 (the V tail mirrors vq); kts/vts [B, KV, 2G] f32;
    lengths [B] int32 = length before this step, new_lengths after it
    (keys at or past (min(new_lengths, S) // G) G are read from the tails);
    ``window``, ``scale``, ``softcap``, ``alibi_slopes``, ``sink_logits`` as
    the module says. Returns [B, T, H, Dh] in q.dtype. Replaces
    ``protoquant_tpu/ops/attention.py:k4v8_attention`` (``_attn_k4v8_kernel``).
    """
    reject_variants("k4v8_attention", **variants)
    window = _window("k4v8_attention", window)
    args = (q, kq, kchs, vq, vs, ktail, kts, vtail, vts, lengths, new_lengths)
    kw = dict(window=window, scale=scale, softcap=softcap, alibi_slopes=alibi_slopes,
              sink_logits=sink_logits)
    if q.device.type == "cpu":
        return k4v8_attention_ref(*args, group=group, **kw)
    return _kivi_attention_launch("k4v8_attention", k4v8_attention, False, *args, group, **kw)


k4v8_attention.launches = 0
# launches by kernel: "split" (kivi_split.cuh, kivi_combine.cu and the
# merge), "prefill" (attn_prefill.cuh, the KIVI instances)
k4v8_attention.routes = {"split": 0, "prefill": 0}


def int4_kv_attention(q, kq, kchs, vq, vs, ktail, kts, vtail, vts, lengths,
                      new_lengths, *, group, window=0, scale=0.0, softcap=0.0,
                      alibi_slopes=None, sink_logits=None, **variants):
    """Causal GQA attention over the Int4 (KIVI) cache: as
    :func:`k4v8_attention` with vq [B, KV, S/2, Dh] packed int4 V and vs
    [B, KV, 2, S/2] its parity-split per-token scales. Replaces
    ``protoquant_tpu/ops/attention.py:int4_kv_attention`` (``_attn4_kernel``)."""
    reject_variants("int4_kv_attention", **variants)
    window = _window("int4_kv_attention", window)
    args = (q, kq, kchs, vq, vs, ktail, kts, vtail, vts, lengths, new_lengths)
    kw = dict(window=window, scale=scale, softcap=softcap, alibi_slopes=alibi_slopes,
              sink_logits=sink_logits)
    if q.device.type == "cpu":
        return int4_kv_attention_ref(*args, group=group, **kw)
    return _kivi_attention_launch("int4_kv_attention", int4_kv_attention, True, *args, group,
                                  **kw)


int4_kv_attention.launches = 0
int4_kv_attention.routes = {"split": 0, "prefill": 0}
