"""W4A8: dynamic int8 activations times group-wise int4 weights on the int8
tensor cores. Kernels and plain versions.

The kernels replace the two bodies of the Pallas kernel
``protoquant_tpu/ops/w4a8_matmul.py``:

* ``two_level`` (``_w4a8_2l_kernel``, what the model runs by default):
  ``scol[n] = max_g s[n, g]``, ``r16 = s * where(scol > 0, 16 / scol, 0)``;
  each code is requantized to int8, ``w8 = rint(q * r16[n, g])`` (half to
  even, |w8| <= 112 for codes in [-7, 7]); one exact int32 dot over all of
  K; ``y = (f32(acc) * (s_x * 0.0625)) * scol + b``.
* ``group`` (``_w4a8_kernel``): an exact int32 dot per K-group,
  ``acc = acc + f32(p) * s[n, g]`` over the groups in ascending order,
  ``y = acc * s_x + b``.

Both kernels equal their plain versions bit for bit. The integer dots of
the plain versions run through float64, as ``core.numerics.int_matmul_nk``
does. The weight is the port's [N, K] layout packed along K (``packed`` int8
[N, K/2], ``scales`` f32 [N, K/group]). A CPU tensor takes the plain
version; a CUDA tensor launches the body's kernel or raises. Each body
counts its own launches.

``two_level`` takes one of two kernels, chosen by the number of token rows
M before launch: M <= ``wo4_matmul.INT4_DECODE_MAX_M`` (every decode step)
the split-K decode kernel (``csrc/w4a8_decode.cu``: weight rows on the
MMA's 16-row side, each (row, group)'s 16 requantized codes built once as
a table and looked up by ``prmt``, K split at group boundaries over a
thread block cluster as ``wo4_matmul.int4_decode_plan`` says, the int32
partials summed in shared memory), larger M the tile kernel
(``csrc/w4a8_tile.cu`` on ``csrc/int4_tile_sm90.cuh``: TMA and wgmma, 128
weight rows by 64, 128 or 256 tokens a block, the codes requantized by a
table a (row, group) at g >= 128, one by one below, K split over a cluster
as ``wo4_matmul.int4_tile_plan`` says). :func:`requant_table`,
:func:`table_lookup` and :func:`w4a8_two_level_splitk_ref` spell the
decode kernel out, :func:`w4a8_two_level_tile_ref` the tile kernel.

``group`` routes the same way, by M <= ``GROUP_DECODE_MAX_M``, and keeps
its bits at both: the decode kernel (``csrc/w4a8_group_decode.cu``) splits
K at group boundaries over a cluster as :func:`group_decode_plan` says,
each block keeping the exact int32 sum of each of its groups in shared
memory (:func:`group_decode_smem` bytes); then each output's chain runs
over all of K's groups in order, reading each sum from the block that owns
it through distributed shared memory. The tile kernel
(``csrc/w4a8_group_tile.cu`` on ``csrc/int4_tile_sm90.cuh``: TMA and
wgmma, 128 weight rows by 64 or 128 tokens a block) keeps a group's int32
sum beside the f32 chain and takes one K split. Both make the codes by the
biased-nibble subtract (:func:`biased_nibble_codes`).
:func:`w4a8_group_splitk_ref` and :func:`w4a8_group_tile_ref` spell them
out. Each wrapper's ``.routes`` counts its kernels.
"""

from __future__ import annotations

import torch

from ..core import numerics
from . import _build
from .gemm_plan import DECODE_MAX_SPLITS, DECODE_ROWS, decode_held, decode_plan
from .wo4_matmul import (check_int4_weight, decodes, int4_decode_held, int4_decode_plan,
                         int4_decode_units, int4_k_slices, int4_tile_blocks, tile_args)

FORMULATIONS = ("two_level", "group")
# The group body's decode kernel (csrc/w4a8_group_decode.cu): the largest M
# routed to it, from the sweep in PERF.md (tools/gemm_timing.py --int4
# --sweep; 32 is also the kernel's limit), and the most shared memory a
# block of it takes (W4G_SMEM, an H100's most a block).
GROUP_DECODE_MAX_M = 16
GROUP_DECODE_SMEM = 227 * 1024


def two_level_scales(scales: torch.Tensor):
    """(r16 f32 [N, G], scol f32 [N]) of the two-level formulation, from
    scales [N, G], by the JAX formula. ``16 / scol`` is a true division
    (PyTorch computes ``16.0 / scol`` as ``reciprocal(scol) * 16``, which
    only a power of two such as 16 keeps exact)."""
    scol = scales.amax(dim=1)
    inv = torch.where(scol > 0, torch.full_like(scol, 16.0) / scol,
                      torch.zeros_like(scol))
    return scales * inv[:, None], scol


def w4a8_matmul_ref(xq, s_x, packed, scales, group=128, bias=None,
                    out_dtype=torch.bfloat16, formulation="group", two_level=None):
    """Plain version (same contract as :func:`w4a8_matmul`), in the TPU
    kernels' order of operations."""
    if formulation not in FORMULATIONS:
        raise ValueError(f"unknown w4a8 formulation {formulation!r}")
    k = xq.shape[-1]
    n = packed.shape[0]
    ng = k // group
    xs = xq.reshape(-1, k)
    sx = s_x.reshape(-1, 1).float()
    q = numerics.unpack_int4(packed, group)
    if formulation == "two_level":
        r16, scol = two_level if two_level is not None else two_level_scales(scales)
        w8 = torch.round(q.float().reshape(n, ng, group) * r16[:, :, None])
        acc = numerics.int_matmul_nk(xs, w8.reshape(n, k).to(torch.int8)).float()
        y = (acc * (sx * 0.0625)) * scol[None, :]
    else:
        m = xs.shape[0]
        p = torch.einsum("gmk,gkn->gmn",
                         xs.to(torch.float64).reshape(m, ng, group).transpose(0, 1),
                         q.to(torch.float64).reshape(n, ng, group).permute(1, 2, 0))
        p = p.to(torch.int32)  # [G, M, N], exact
        acc = torch.zeros(m, n, dtype=torch.float32, device=xq.device)
        for gi in range(ng):
            acc = acc + p[gi].float() * scales[:, gi]
        y = acc * sx
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype).reshape(*xq.shape[:-1], n)


def requant_table(r16: torch.Tensor) -> torch.Tensor:
    """The decode kernel's table: int8 [N, G, 16], entry u the code c = u -
    8 requantized as the kernel does it, the low byte of the f32 sum
    ``c * r16 + 1.5 * 2**23`` (an f32 multiply, then an add that rounds to
    an integer, half to even), so ``rint(c * r16)``."""
    c = torch.arange(-8, 8, dtype=torch.float32, device=r16.device)
    y = r16.float()[:, :, None] * c + 12582912.0
    return (y.view(torch.int32) & 0xFF).to(torch.uint8).view(torch.int8)


def prmt(a: torch.Tensor, b: torch.Tensor, s) -> torch.Tensor:
    """PTX ``prmt.b32`` in its default mode on unsigned 32-bit words held
    in int64 tensors: byte i of the result is byte (s_i & 7) of {a, b}
    (a's bytes 0-3, b's 4-7), or, where bit 3 of s's nibble i is set, that
    byte's bit 7 replicated over the byte. Only s's low 16 bits count."""
    s = torch.as_tensor(s, dtype=torch.int64, device=a.device)
    src = torch.stack([(a >> (8 * j)) & 0xFF for j in range(4)]
                      + [(b >> (8 * j)) & 0xFF for j in range(4)])
    out = torch.zeros_like(a)
    for i in range(4):
        nib = (s >> (4 * i)) & 0xF
        byte = torch.gather(src, 0, (nib & 7).expand_as(a)[None])[0]
        byte = torch.where((nib & 8) != 0, ((byte >> 7) & 1) * 0xFF, byte)
        out = out | (byte << (8 * i))
    return out


def table_words(table: torch.Tensor) -> list:
    """A table's 16 int8 entries (last dim) as the kernel's 4 words,
    entries 4q .. 4q + 3 in word q, lowest byte first (int64 tensors)."""
    u = table.to(torch.int64) & 0xFF
    return [u[..., 4 * q] | (u[..., 4 * q + 1] << 8) | (u[..., 4 * q + 2] << 16)
            | (u[..., 4 * q + 3] << 24) for q in range(4)]


def table_lookup(words: list, w: torch.Tensor):
    """The decode kernel's lookup of one weight word w (4 packed bytes,
    int64 0 .. 2**32 - 1): (lo, hi), the requantized codes of the nibbles
    lo0, hi0, lo1, hi1 and lo2, hi2, lo3, hi3 (lo_j, hi_j the low and high
    nibble of byte j), one byte each. The raw nibble picks among the
    entries of c >= 0, the nibble with bit 3 flipped among those of c < 0,
    and bit 3 of each nibble, replicated into a byte mask, picks one."""
    wx, sh = w ^ 0x88888888, (w << 4) & 0xFFFFFFFF
    out = []
    for half, mask_sel in ((0, 0xD9C8), (16, 0xFBEA)):
        pos = prmt(words[2], words[3], w >> half)
        neg = prmt(words[0], words[1], wx >> half)
        m = prmt(sh, w, mask_sel)
        out.append((pos & ~m & 0xFFFFFFFF) | (neg & m))
    return tuple(out)


def w4a8_two_level_splitk_ref(xq, s_x, packed, r16, scol, group=128, bias=None,
                              out_dtype=torch.bfloat16, k_splits=1):
    """The decode kernel in plain PyTorch: codes through
    :func:`requant_table`, the exact int32 product of each K slice
    (``wo4_matmul.int4_k_slices``), the slices' partials summed, then the
    epilogue (f32(acc) * (s_x * 0.0625)) * scol + bias. Equal to
    ``w4a8_matmul_ref(..., formulation="two_level")`` bit for bit at any
    ``k_splits``."""
    k = xq.shape[-1]
    n = packed.shape[0]
    ng = k // group
    xs = xq.reshape(-1, k)
    u = (numerics.unpack_int4(packed, group).to(torch.int64) + 8).reshape(n, ng, group)
    w8 = torch.gather(requant_table(r16), 2, u).reshape(n, k)
    acc = torch.zeros(xs.shape[0], n, dtype=torch.int32, device=xq.device)
    for k0, k1 in int4_k_slices(k, group, k_splits):
        acc += numerics.int_matmul_nk(xs[:, k0:k1], w8[:, k0:k1])
    y = (acc.float() * (s_x.reshape(-1, 1).float() * 0.0625)) * scol[None, :]
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype).reshape(*xq.shape[:-1], n)


def w4a8_two_level_tile_ref(xq, s_x, packed, r16, scol, group=128, bias=None,
                            out_dtype=torch.bfloat16, plan=(256, 1)):
    """The tile kernel in plain PyTorch: each code requantized on its own,
    the low byte of the f32 sum ``fl(c * r16) + 1.5 * 2**23``; each block
    of ``wo4_matmul.int4_tile_blocks`` the exact int32 product over its K
    slice, a tile's slices summed; then the epilogue (f32(acc) * (s_x *
    0.0625)) * scol + bias. Equal to ``w4a8_matmul_ref(...,
    formulation="two_level")`` bit for bit at any plan."""
    k = xq.shape[-1]
    n = packed.shape[0]
    xs = xq.reshape(-1, k)
    q = numerics.unpack_int4(packed, group).float().reshape(n, k // group, group)
    y = q * r16.float()[:, :, None] + 12582912.0
    w8 = (y.view(torch.int32) & 0xFF).to(torch.uint8).view(torch.int8).reshape(n, k)
    acc = torch.zeros(xs.shape[0], n, dtype=torch.int32, device=xq.device)
    for (m0, m1), (n0, n1), (k0, k1) in int4_tile_blocks(xs.shape[0], n, k, group, plan):
        acc[m0:m1, n0:n1] += numerics.int_matmul_nk(xs[m0:m1, k0:k1], w8[n0:n1, k0:k1])
    y = (acc.float() * (s_x.reshape(-1, 1).float() * 0.0625)) * scol[None, :]
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype).reshape(*xq.shape[:-1], n)


def biased_nibble_codes(packed: torch.Tensor, group: int) -> torch.Tensor:
    """The group kernels' codes, int8 [N, K] in K order: each nibble u of
    the packed bytes biased, ``u ^ 8``, then less 8 as the kernels take it
    in its byte, ``((u ^ 8) + 0x78) ^ 0x80`` (no byte carries out:
    ``u ^ 8 <= 15``). Equal to ``numerics.unpack_int4``."""
    n, kb = packed.shape
    u = packed.to(torch.int64) & 0xFF
    codes = [((((u >> shift) & 0xF) ^ 8) + 0x78) ^ 0x80 for shift in (0, 4)]
    lo, hi = (c.to(torch.uint8).view(torch.int8).reshape(n, -1, group // 2) for c in codes)
    return torch.cat([lo, hi], dim=2).reshape(n, 2 * kb)


def group_decode_smem(m: int, k: int, group: int, splits: int) -> int:
    """Bytes of shared memory a block of the group decode kernel keeps for
    ``splits`` K splits: the most units of K a split holds
    (``wo4_matmul.int4_decode_units``), times the groups a unit, times a
    group's int32 sums, 8 tokens a fragment (1, 2 or 4 for m <= 8, 16, 32)
    by 64 weight rows padded to 68 (``w4g_smem``)."""
    units, unit = int4_decode_units(k, group)
    mf = 1 if m <= 8 else 2 if m <= 16 else 4
    return -(-units // splits) * (unit // group) * 8 * mf * (DECODE_ROWS + 4) * 4


def group_decode_plan(m: int, n: int, k: int, group: int, held: dict):
    """The group decode kernel's K splits for an [m, k] x [n, k]^T product,
    or None where the tile kernel takes it (m > ``GROUP_DECODE_MAX_M``, or
    no split's group terms fit ``GROUP_DECODE_SMEM``): of the splits whose
    terms fit, ``gemm_plan.decode_plan``'s where its clusters fit one wave
    (``held``: :func:`group_decode_held`, which counts the terms); where
    none does, the least waves a split (waves x 1 / splits; the fewer
    splits on a tie), each split keeping two units where it can (the sweep
    in PERF.md: at lm_head 2 splits in 2 waves beat 1 in 2 by 1.4x)."""
    if m > GROUP_DECODE_MAX_M:
        return None
    units, _ = int4_decode_units(k, group)
    room = [s for s in range(1, DECODE_MAX_SPLITS + 1)
            if s <= units and group_decode_smem(m, k, group, s) <= GROUP_DECODE_SMEM]
    if not room:
        return None
    fit = {s: held[s] if s in room else 0 for s in held}
    tiles = -(-n // DECODE_ROWS)
    splits = decode_plan(n, units, fit)
    if tiles <= fit[splits]:
        return splits
    pick = [s for s in room if s == 1 or 2 * s <= units] or room
    return min(pick, key=lambda s: (-(-tiles // max(1, fit[s])) / s, s))


def group_decode_held(dev, m: int, k: int, group: int) -> dict:
    """{splits: clusters of that many blocks the card holds at once} of the
    group decode kernel instance for ``m`` rows at (k, group), each block
    with its group sums in shared memory (``gemm_plan.decode_held``; 0
    where the sums do not fit)."""
    return decode_held("pq_w4a8_group_decode", dev, m, k, group)


def w4a8_group_splitk_ref(xq, s_x, packed, scales, group=128, bias=None,
                          out_dtype=torch.bfloat16, k_splits=1):
    """The group decode kernel in plain PyTorch: each K slice
    (``wo4_matmul.int4_k_slices``) keeps the exact int32 sum of each of its
    groups; then one chain over the slices in order and each slice's groups
    in order, ``acc = acc + f32(p) * s[n, g]``; then ``acc * s_x + bias``.
    Equal to ``w4a8_matmul_ref(..., formulation="group")`` bit for bit at
    any ``k_splits``."""
    k = xq.shape[-1]
    n = packed.shape[0]
    xs = xq.reshape(-1, k)
    q = biased_nibble_codes(packed, group)
    sums = [[(g0 // group, numerics.int_matmul_nk(xs[:, g0:g0 + group], q[:, g0:g0 + group]))
             for g0 in range(k0, k1, group)]
            for k0, k1 in int4_k_slices(k, group, k_splits)]
    acc = torch.zeros(xs.shape[0], n, dtype=torch.float32, device=xq.device)
    for part in sums:
        for gi, p in part:
            acc = acc + p.float() * scales[:, gi]
    y = acc * s_x.reshape(-1, 1).float()
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype).reshape(*xq.shape[:-1], n)


def w4a8_group_tile_ref(xq, s_x, packed, scales, group=128, bias=None,
                        out_dtype=torch.bfloat16, plan=(128, 1)):
    """The group tile kernel in plain PyTorch: each block of
    ``wo4_matmul.int4_tile_blocks`` runs the chain over its groups in
    order, ``acc = acc + f32(p) * s[n, g]`` with p the group's exact int32
    sum; then ``acc * s_x + bias``. The kernel takes one K split, so
    ``plan`` = (tokens a tile, 1); equal to ``w4a8_matmul_ref(...,
    formulation="group")`` bit for bit at any such plan."""
    if plan[1] != 1:
        raise ValueError(f"w4a8 group tile: plan {plan}: one K split (the chain runs in order)")
    k = xq.shape[-1]
    n = packed.shape[0]
    xs = xq.reshape(-1, k)
    q = biased_nibble_codes(packed, group)
    y = torch.zeros(xs.shape[0], n, dtype=torch.float32, device=xq.device)
    for (m0, m1), (n0, n1), (k0, k1) in int4_tile_blocks(xs.shape[0], n, k, group, plan):
        acc = torch.zeros(m1 - m0, n1 - n0, dtype=torch.float32, device=xq.device)
        for g0 in range(k0, k1, group):
            p = numerics.int_matmul_nk(xs[m0:m1, g0:g0 + group], q[n0:n1, g0:g0 + group])
            acc = acc + p.float() * scales[n0:n1, g0 // group]
        y[m0:m1, n0:n1] = acc
    y = y * s_x.reshape(-1, 1).float()
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype).reshape(*xq.shape[:-1], n)


def _launch(fn_name, xq, s_x, packed, table, scol, group, bias, out_dtype, tail=None):
    """Check the operands and launch ``fn_name``; ``tail(m, n, k, dev)``
    gives the arguments after ``group`` (as ``wo4_matmul``'s)."""
    k = xq.shape[-1]
    n, bias = check_int4_weight(fn_name, k, packed, table, group, bias)
    if xq.dtype != torch.int8 or s_x.dtype != torch.float32:
        raise TypeError(f"{fn_name}: xq must be int8 and s_x float32")
    if s_x.shape != xq.shape[:-1]:
        raise ValueError(f"{fn_name}: shapes xq {tuple(xq.shape)}, s_x {tuple(s_x.shape)}")
    if out_dtype not in _build.DTYPE_CODES:
        raise TypeError(f"{fn_name}: unsupported out_dtype {out_dtype}")
    xq, s_x = xq.contiguous(), s_x.contiguous()
    tensors = [xq, s_x, packed, table] + [t for t in (scol, bias) if t is not None]
    dev = _build.same_device_contiguous(fn_name, *tensors)
    if dev.type != "cuda":
        raise ValueError(f"{fn_name}: launches on CUDA tensors only, got {dev}")
    if xq.data_ptr() % 16 or packed.data_ptr() % 16:
        raise ValueError(f"{fn_name}: xq and packed must be 16-byte aligned")
    m = xq.numel() // k
    out = torch.empty(*xq.shape[:-1], n, dtype=out_dtype, device=dev)
    ptrs = [xq.data_ptr(), s_x.data_ptr(), packed.data_ptr(), table.data_ptr()]
    if scol is not None:
        ptrs.append(scol.data_ptr())
    args = [*ptrs, bias.data_ptr() if bias is not None else None, out.data_ptr(),
            _build.DTYPE_CODES[out_dtype], m, n, k, group]
    if tail is not None:
        args += tail(m, n, k, dev)
    err = getattr(_build.lib(), fn_name)(*args, _build.stream_ptr(dev))
    _build.check(err, fn_name)
    return out


def w4a8_two_level_launch(xq, s_x, packed, r16, scol, group, bias=None,
                          out_dtype=torch.bfloat16, k_splits=None, tile=None):
    """Launch one two-level kernel on CUDA operands: the decode kernel with
    ``k_splits`` (1 to 8) K splits, or for None the tile kernel with
    ``tile`` = (tokens a tile, K splits) (None:
    ``wo4_matmul.int4_tile_plan``'s). Returns the output; counts nothing
    (:func:`w4a8_two_level` routes and counts)."""
    if r16.dtype != torch.float32 or scol.dtype != torch.float32:
        raise TypeError("w4a8 two_level: r16 and scol must be float32")
    if scol.shape != (packed.shape[0],):
        raise ValueError(f"w4a8 two_level: scol shape {tuple(scol.shape)}")
    if k_splits is not None:
        return _launch("pq_w4a8_two_level_decode", xq, s_x, packed, r16, scol, group, bias,
                       out_dtype, lambda *_: [k_splits])
    return _launch("pq_w4a8_two_level", xq, s_x, packed, r16, scol, group, bias, out_dtype,
                   tile_args(tile, "two_level", group))


def w4a8_two_level(xq, s_x, packed, r16, scol, group, bias=None, out_dtype=torch.bfloat16):
    """Launch the two-level body on CUDA tensors, with (r16, scol) from
    :func:`two_level_scales`. M up to ``wo4_matmul.INT4_DECODE_MAX_M``
    takes the decode kernel, larger M the tile kernel."""
    k = xq.shape[-1]
    m = xq.numel() // k if k else 0
    splits = (int4_decode_plan(m, packed.shape[0], k, group,
                               int4_decode_held("pq_w4a8_two_level_decode", xq.device, m, group))
              if decodes(xq, m, group) else None)
    out = w4a8_two_level_launch(xq, s_x, packed, r16, scol, group, bias, out_dtype, splits)
    w4a8_two_level.launches += 1
    w4a8_two_level.routes["tile" if splits is None else "decode"] += 1
    return out


def w4a8_group_launch(xq, s_x, packed, scales, group, bias=None, out_dtype=torch.bfloat16,
                      k_splits=None, tile=None):
    """Launch one group kernel on CUDA operands: the decode kernel with
    ``k_splits`` (1 to 8) K splits, or for None the tile kernel with
    ``tile`` = (tokens a tile, 1) (None: ``wo4_matmul.int4_tile_plan``'s).
    Returns the output; counts nothing (:func:`w4a8_group` routes and
    counts)."""
    if k_splits is not None:
        return _launch("pq_w4a8_group_decode", xq, s_x, packed, scales, None, group, bias,
                       out_dtype, lambda *_: [k_splits])
    return _launch("pq_w4a8_group_tile", xq, s_x, packed, scales, None, group, bias,
                   out_dtype, tile_args(tile, "group", group))


def w4a8_group(xq, s_x, packed, scales, group, bias=None, out_dtype=torch.bfloat16):
    """Launch the per-group body on CUDA tensors. M up to
    ``GROUP_DECODE_MAX_M`` takes the decode kernel at
    :func:`group_decode_plan`'s splits (where its group sums fit a block),
    larger M the tile kernel."""
    k = xq.shape[-1]
    m = xq.numel() // k if k else 0
    splits = (group_decode_plan(m, packed.shape[0], k, group,
                                group_decode_held(xq.device, m, k, group))
              if decodes(xq, m, group, GROUP_DECODE_MAX_M) and k % group == 0 else None)
    out = w4a8_group_launch(xq, s_x, packed, scales, group, bias, out_dtype, splits)
    w4a8_group.launches += 1
    w4a8_group.routes["tile" if splits is None else "decode"] += 1
    return out


w4a8_two_level.launches = 0
# launches by kernel: "decode" (w4a8_decode.cu), "tile" (w4a8_tile.cu)
w4a8_two_level.routes = {"decode": 0, "tile": 0}
w4a8_group.launches = 0
# launches by kernel: "decode" (w4a8_group_decode.cu), "tile" (w4a8_group_tile.cu)
w4a8_group.routes = {"decode": 0, "tile": 0}


def w4a8_matmul(xq: torch.Tensor, s_x: torch.Tensor, packed: torch.Tensor,
                scales: torch.Tensor, group: int = 128, bias: torch.Tensor | None = None,
                out_dtype=torch.bfloat16, formulation: str = "group",
                two_level=None) -> torch.Tensor:
    """y = (s_x * xq) @ dequant_int4(packed, scales)^T + bias, cast to
    ``out_dtype``, through int8 x int8 -> int32 dots.

    xq int8 [..., K] and s_x f32 [...] (a rowquant pass); packed int8
    [N, K/2]; scales f32 [N, K/group]; bias f32 [N] or None.
    ``formulation``: ``"group"`` (exact int4 semantics, the JAX op's
    default) or ``"two_level"`` (the model's default,
    ``ops.resolve_w4a8_formulation()``). ``two_level``: (r16, scol) from
    :func:`two_level_scales`, made once per weight; computed here when None.
    On CUDA, group is one of ``wo4_matmul.CUDA_GROUPS``.
    """
    if formulation not in FORMULATIONS:
        raise ValueError(f"unknown w4a8 formulation {formulation!r}")
    if xq.device.type == "cpu":
        return w4a8_matmul_ref(xq, s_x, packed, scales, group, bias, out_dtype,
                               formulation, two_level)
    if formulation == "group":
        return w4a8_group(xq, s_x, packed, scales, group, bias, out_dtype)
    r16, scol = two_level if two_level is not None else two_level_scales(scales)
    return w4a8_two_level(xq, s_x, packed, r16, scol, group, bias, out_dtype)
