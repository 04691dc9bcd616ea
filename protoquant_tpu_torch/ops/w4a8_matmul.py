"""W4A8: dynamic int8 activations times group-wise int4 weights on the int8
tensor cores. Kernels and plain versions.

The kernels (``csrc/w4a8_matmul.cu``) replace the two bodies of the Pallas
kernel ``protoquant_tpu/ops/w4a8_matmul.py``:

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
"""

from __future__ import annotations

import torch

from ..core import numerics
from . import _build
from .wo4_matmul import check_int4_weight

FORMULATIONS = ("two_level", "group")


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


def _launch(fn_name, xq, s_x, packed, table, scol, group, bias, out_dtype):
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
    err = getattr(_build.lib(), fn_name)(
        *ptrs, bias.data_ptr() if bias is not None else None, out.data_ptr(),
        _build.DTYPE_CODES[out_dtype], m, n, k, group, _build.stream_ptr(dev))
    _build.check(err, fn_name)
    return out


def w4a8_two_level(xq, s_x, packed, r16, scol, group, bias=None, out_dtype=torch.bfloat16):
    """Launch the two-level body on CUDA tensors, with (r16, scol) from
    :func:`two_level_scales`."""
    if r16.dtype != torch.float32 or scol.dtype != torch.float32:
        raise TypeError("w4a8 two_level: r16 and scol must be float32")
    if scol.shape != (packed.shape[0],):
        raise ValueError(f"w4a8 two_level: scol shape {tuple(scol.shape)}")
    out = _launch("pq_w4a8_two_level", xq, s_x, packed, r16, scol, group, bias, out_dtype)
    w4a8_two_level.launches += 1
    return out


def w4a8_group(xq, s_x, packed, scales, group, bias=None, out_dtype=torch.bfloat16):
    """Launch the per-group body on CUDA tensors."""
    out = _launch("pq_w4a8_group", xq, s_x, packed, scales, None, group, bias, out_dtype)
    w4a8_group.launches += 1
    return out


w4a8_two_level.launches = 0
w4a8_group.launches = 0


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
