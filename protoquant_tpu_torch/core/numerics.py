"""Plain PyTorch statement of the protoquant numerics contract.

Every kernel in ``protoquant_tpu_torch.ops`` matches these functions bit for
bit on the integer path (codes, scales, int32 sums) and in the f32 epilogue.

  * Weight: per-output-channel symmetric int8, static.
      s_w[n]  = max(max_k |W[k, n]| / 127, 1e-12)
      Wq[k,n] = clamp(round(W[k,n] / s_w[n]), -127, 127)
  * Activation: per-token (per-row) symmetric int8, dynamic.
      s_x[m]  = max(max_k |x[m, k]| / 127, 1e-12)
      xq[m,k] = clamp(round(x[m,k] / s_x[m]), -127, 127)
  * GEMM and epilogue:
      acc[m,n] = sum_k xq[m,k] * Wq[k,n]          (exact integer sum)
      y[m,n]   = (acc[m,n] * s_x[m]) * s_w[n] + b[n]   (f32, in that order)
  * int4 weights (below): codes in [-7, 7] with one scale per (output
    channel, K-group), packed two per byte.

Quantization divides (``x / s``, IEEE round-to-nearest), never multiplies by
a reciprocal; rounding is half-to-even (``torch.round``).

The integer dot runs in float64, on any device: CUDA has no int32 matmul,
and f32 cannot hold an int32 sum of 11008 products of int8 codes exactly,
while float64 holds every such sum up to 2**53.
"""

from __future__ import annotations

import torch

# Symmetric int8 range [-127, 127]: negation is closed and no zero points.
QMAX = 127
# Scale floor for all-zero rows and channels: every value quantizes to 0.
SCALE_EPS = 1e-12


def compute_scale(x: torch.Tensor, dim: int, qmax: int = QMAX) -> torch.Tensor:
    """absmax / qmax along ``dim`` (reduced away), floored at SCALE_EPS."""
    amax = x.float().abs().amax(dim=dim)
    # Divide by a tensor, not a Python number: on CUDA, PyTorch turns
    # division by a CPU scalar into a multiply by its reciprocal, which is
    # one ulp off the contract for some amax values.
    return torch.clamp_min(amax / amax.new_full((), float(qmax)), SCALE_EPS)


def quantize(x: torch.Tensor, scale: torch.Tensor, dim: int,
             qmax: int = QMAX) -> torch.Tensor:
    """Symmetric int8 codes of ``x`` under ``scale`` (``x`` reduced over ``dim``)."""
    q = torch.round(x.float() / scale.unsqueeze(dim))
    return q.clamp(-qmax, qmax).to(torch.int8)


def quantize_rowwise(x: torch.Tensor, qmax: int = QMAX):
    """Per-row quantization over the last axis: (xq int8, s_x f32 x.shape[:-1])."""
    scale = compute_scale(x, dim=-1, qmax=qmax)
    return quantize(x, scale, dim=-1, qmax=qmax), scale


def quantize_channelwise(w: torch.Tensor, dim: int = 0, qmax: int = QMAX):
    """Per-channel weight quantization reducing ``dim``: (wq int8, s_w f32).

    A [K, N] weight with ``dim=0`` gives per-output-channel scales [N]; an
    ``nn.Linear``-layout [N, K] weight takes ``dim=1``.
    """
    scale = compute_scale(w, dim=dim, qmax=qmax)
    return quantize(w, scale, dim=dim, qmax=qmax), scale


def dequantize(q: torch.Tensor, scale: torch.Tensor, dim: int) -> torch.Tensor:
    """int8 codes times their scale, in f32."""
    return q.float() * scale.unsqueeze(dim)


def int_matmul_nk(xq: torch.Tensor, wq_nk: torch.Tensor) -> torch.Tensor:
    """Exact int8 [M, K] x int8 [N, K]^T -> int32 [M, N], through float64."""
    acc = xq.to(torch.float64) @ wq_nk.to(torch.float64).t()
    return acc.to(torch.int32)


def qmatmul_ref(xq: torch.Tensor, wq_nk: torch.Tensor, s_x: torch.Tensor,
                s_w: torch.Tensor, bias: torch.Tensor | None = None,
                out_dtype=torch.float32) -> torch.Tensor:
    """Integer GEMM and fused f32 epilogue.

    xq int8 [..., K]; wq_nk int8 [N, K] (the ``nn.Linear`` layout); s_x f32
    [...]; s_w f32 [N]. y = (acc * s_x) * s_w + bias, cast to ``out_dtype``.
    """
    k = xq.shape[-1]
    acc = int_matmul_nk(xq.reshape(-1, k), wq_nk).float()
    y = acc * s_x.reshape(-1, 1).float() * s_w.float()[None, :]
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype).reshape(*xq.shape[:-1], wq_nk.shape[0])


def dynamic_qlinear_ref(x: torch.Tensor, wq_nk: torch.Tensor, s_w: torch.Tensor,
                        bias: torch.Tensor | None = None,
                        out_dtype=None) -> torch.Tensor:
    """rowquant(x) -> integer GEMM -> epilogue, all plain PyTorch."""
    xq, s_x = quantize_rowwise(x)
    return qmatmul_ref(xq, wq_nk, s_x, s_w, bias, out_dtype or x.dtype)


# ---------------------------------------------------------------------------
# int4, group-wise: symmetric 4-bit weights with one f32 scale per (output
# channel, K-group). The port keeps a weight [N, K] (K contiguous), so every
# function here works along the last axis: codes [N, K], scales [N, K/g],
# packed bytes [N, K/2]. They are the JAX package's [K, N] functions,
# transposed, and give the same codes and scales bit for bit.
# ---------------------------------------------------------------------------

QMAX4 = 7
# The "mse" clip's candidate ratios r of the group amax (r / 7 is the step).
INT4_CLIP_RATIOS = tuple(0.5 + 0.025 * i for i in range(21))


def quantize_groupwise_int4(w: torch.Tensor, group: int = 128, clip: str = "mse"):
    """[N, K] -> (q int8 [N, K] in [-7, 7], scales f32 [N, K/group]).

    ``clip="amax"``: the step is the group's amax / 7 (nothing clips).
    ``clip="mse"``: 21 candidate steps amax * (r / 7), r = 0.5 + 0.025 i,
    each floored at SCALE_EPS; a candidate replaces the best so far only if
    its squared reconstruction error, summed over the group, is strictly
    smaller, so ties keep the smaller r.
    """
    n, k = w.shape
    if k % group:
        raise ValueError(f"K={k} not divisible by group={group}")
    wg = w.float().reshape(n, k // group, group)
    amax = wg.abs().amax(dim=2)  # [N, G]
    if clip == "mse":
        best_err = best_scale = None
        for r in INT4_CLIP_RATIOS:
            # r / 7 is a Python double rounded once to f32, as JAX's weak
            # typing rounds it, then one f32 multiply
            s = torch.clamp_min(amax * amax.new_full((), r / QMAX4), SCALE_EPS)
            qc = torch.round(wg / s[:, :, None]).clamp(-QMAX4, QMAX4)
            err = ((qc * s[:, :, None] - wg) ** 2).sum(dim=2)
            if best_err is None:
                best_err, best_scale = err, s
            else:
                take = err < best_err
                best_err = torch.where(take, err, best_err)
                best_scale = torch.where(take, s, best_scale)
        scale = best_scale
    elif clip == "amax":
        scale = torch.clamp_min(amax / amax.new_full((), float(QMAX4)), SCALE_EPS)
    else:
        raise ValueError(f"unknown int4 clip mode {clip!r}")
    q = torch.round(wg / scale[:, :, None]).clamp(-QMAX4, QMAX4)
    return q.reshape(n, k).to(torch.int8), scale


def pack_int4(q: torch.Tensor, group: int | None = None) -> torch.Tensor:
    """Two int4 codes per byte along the last axis: [N, K] -> int8 [N, K/2].

    Packing is group-local: within each K-group of ``group`` codes (default
    all of K), byte j holds k = j in its low nibble and k = j + group/2 in
    its high nibble.
    """
    n, k = q.shape
    g = group or k
    if k % g or g % 2:
        raise ValueError(f"K={k} must divide into even groups of {g}")
    qg = q.reshape(n, k // g, g).to(torch.int32)
    low = qg[:, :, : g // 2] & 0xF
    high = (qg[:, :, g // 2:] & 0xF) << 4
    return (low | high).to(torch.uint8).view(torch.int8).reshape(n, k // 2)


def unpack_int4(packed: torch.Tensor, group: int | None = None) -> torch.Tensor:
    """Inverse of :func:`pack_int4`: int8 [N, K/2] -> int8 [N, K] in [-8, 7]."""
    n, k2 = packed.shape
    g = group or 2 * k2
    u = packed.to(torch.int32).reshape(n, 2 * k2 // g, g // 2)
    low = (u << 28) >> 28  # sign-extend the low nibble
    high = (u << 24) >> 28
    return torch.cat([low, high], dim=2).reshape(n, 2 * k2).to(torch.int8)


def pack_nib_pair(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Two nibble values in [-8, 7] (integer tensors) -> one byte each:
    ``lo`` in bits 0-3, ``hi`` in bits 4-7, two's-complement nibbles."""
    return ((lo.to(torch.int32) & 0x0F) | (hi.to(torch.int32) << 4)).to(torch.int8)


def unpack_nib_pair(packed: torch.Tensor):
    """Inverse of :func:`pack_nib_pair`: (lo, hi) int32, sign-extended."""
    u = packed.to(torch.int32)
    return (u << 28) >> 28, (u << 24) >> 28


def _kivi_requant(xf: torch.Tensor, dim: int):
    """Int4 codes of f32 values under one scale per slice reduced over
    ``dim``: s = max(amax * f32(1/7), 1e-12) (a multiply by the f32
    reciprocal constant, as the JAX package writes it), nib = clamp(round(x
    / s), -7, 7) dividing by a tensor. Returns (nib int32, s)."""
    inv7 = xf.new_full((), 1.0 / QMAX4)
    s = torch.clamp_min(xf.abs().amax(dim=dim) * inv7, SCALE_EPS)
    nib = torch.round(xf / s.unsqueeze(dim)).clamp(-QMAX4, QMAX4).to(torch.int32)
    return nib, s


def kivi_chunk_quantize_k(k8c: torch.Tensor, ksc: torch.Tensor):
    """The K half of :func:`kivi_chunk_quantize`: (packed_k [B, KV, G/2,
    Dh] int8, s_ch [B, KV, Dh] f32)."""
    kf = k8c.float() * ksc.unsqueeze(-1)
    nib, s_ch = _kivi_requant(kf, 2)
    return pack_nib_pair(nib[:, :, 0::2], nib[:, :, 1::2]), s_ch


def kivi_chunk_quantize_v(v8c: torch.Tensor, vsc: torch.Tensor):
    """The V half of :func:`kivi_chunk_quantize`: (packed_v [B, KV, G/2,
    Dh] int8, s_v [B, KV, G] f32)."""
    vf = v8c.float() * vsc.unsqueeze(-1)
    nib, s_v = _kivi_requant(vf, 3)
    return pack_nib_pair(nib[:, :, 0::2], nib[:, :, 1::2]), s_v


def kivi_chunk_quantize(k8c, ksc, v8c, vsc):
    """Requantize one complete G-token chunk from its int8 tail values: K
    per (chunk, channel), V per token; token pairs packed (token 2r in the
    low nibble, 2r + 1 in the high one).

    k8c/v8c: [B, KV, G, Dh] int8;  ksc/vsc: [B, KV, G] f32.
    Returns (packed_k [B, KV, G/2, Dh] int8, s_ch [B, KV, Dh] f32,
             packed_v [B, KV, G/2, Dh] int8, s_v [B, KV, G] f32),
    bit for bit the JAX package's ``models/kv_cache.py:kivi_chunk_quantize``.
    """
    return (*kivi_chunk_quantize_k(k8c, ksc), *kivi_chunk_quantize_v(v8c, vsc))


def dequantize_int4(packed: torch.Tensor, scales: torch.Tensor, group: int) -> torch.Tensor:
    """Codes times their group's scale, f32 [N, K]."""
    q = unpack_int4(packed, group)
    n, k = q.shape
    return (q.float().reshape(n, k // group, group) * scales[:, :, None]).reshape(n, k)


def weight_only_int4_linear_ref(x, packed, scales, group, bias=None, out_dtype=None):
    """Dequantize the int4 weight to f32, then one f32 product:
    y = x @ (q * s)^T + bias. ``packed`` [N, K/2], ``scales`` [N, K/g]."""
    out_dtype = out_dtype or x.dtype
    w = dequantize_int4(packed, scales, group)
    y = x.float() @ w.t()
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype)


def dynamic_int4_linear_ref(x, packed, scales, group, bias=None, out_dtype=None):
    """W4A8: per-row int8 activations times int4 weights, an exact integer
    dot per group, f32 scale after the dot:
    y[m, n] = s_x[m] * sum_g s_w[n, g] * (xq[m, g] . q[n, g]) + bias."""
    out_dtype = out_dtype or x.dtype
    xq, s_x = quantize_rowwise(x)
    q = unpack_int4(packed, group)
    n, k = q.shape
    m = xq.numel() // k
    acc = torch.einsum("mgk,ngk->mgn",
                       xq.reshape(m, k // group, group).to(torch.float64),
                       q.reshape(n, k // group, group).to(torch.float64))
    y = (acc.float() * scales.t()[None]).sum(dim=1)
    y = y * s_x.reshape(-1, 1).float()
    if bias is not None:
        y = y + bias.float()
    return y.reshape(*x.shape[:-1], n).to(out_dtype)
