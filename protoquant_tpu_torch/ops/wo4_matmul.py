"""Weight-only int4 matmul: activations times group-wise int4 weights.
Kernels and plain versions.

The kernels (``csrc/wo4_matmul.cu``) replace the two bodies of the Pallas
kernel ``protoquant_tpu/ops/wo4_matmul.py``:

* ``split`` (``_wo4_split_kernel``, the default): x is rounded to bf16;
  for each K-group g, ``p = x_g . q_g`` (exact products bf16 x nibble,
  summed in f32), then ``acc = acc + p * s[n, g]`` over the groups in
  ascending order, each a separate f32 multiply and add; ``y = acc + b``.
* ``legacy`` (``_wo4_kernel``): ``w = q * s`` in f32, x in f32 (not
  rounded to bf16), one f32 dot, ``y = acc + b``.

The weight is the port's [N, K] layout packed along K: ``packed`` int8
[N, K/2] (``core.numerics.pack_int4``), ``scales`` f32 [N, K/group]. A CPU
tensor takes the plain version; a CUDA tensor launches the body's kernel or
raises. Each body counts its own launches (``wo4_split.launches``,
``wo4_legacy.launches``).
"""

from __future__ import annotations

import torch

from ..core import numerics
from . import _build

FORMULATIONS = ("split", "legacy")
# Groups the CUDA kernels take (pick_int4_group gives 128 for every
# Llama-2-7B projection).
CUDA_GROUPS = (32, 64, 128, 256)


def check_int4_weight(name: str, k: int, packed: torch.Tensor, scales: torch.Tensor,
                      group: int, bias: torch.Tensor | None):
    """Validate an int4 weight for the CUDA kernels; return (N, bias f32)."""
    n = packed.shape[0]
    if k % group:
        raise ValueError(f"{name}: K={k} not divisible by group={group}")
    if group not in CUDA_GROUPS:
        raise ValueError(f"{name}: group={group} must be one of {CUDA_GROUPS} on CUDA "
                         "(the kernels are built for each)")
    if packed.shape != (n, k // 2) or scales.shape != (n, k // group):
        raise ValueError(f"{name}: shapes packed {tuple(packed.shape)}, scales "
                         f"{tuple(scales.shape)} for K={k}, group={group}")
    if packed.dtype != torch.int8 or scales.dtype != torch.float32:
        raise TypeError(f"{name}: packed must be int8 and scales float32")
    if bias is not None:
        if bias.shape != (n,):
            raise ValueError(f"{name}: bias shape {tuple(bias.shape)}")
        bias = bias.float().contiguous()
    return n, bias


def weight_only_int4_tolerance(x, packed, scales, group, y, formulation="split",
                               w_rel: float = 0.0):
    """How far two correct versions of the product may differ at each
    output ``y``. Every version sums the same products (x rounded to bf16
    for ``split``, f32 for ``legacy``) in its own order; each lies within
    ``K * 2**-24 * sum_k |x * q * s|`` of the exact sum (first order: the
    f32 additions, and for ``legacy`` the rounding of each product), so two
    differ by at most twice that. ``w_rel``: add ``w_rel * sum_k |x * q * s|``
    for a version that rounds each weight ``q * s`` by a relative ``w_rel``
    (2**-8 for a bf16 copy of the weight). Then the cast to ``y.dtype`` may
    round the two sums one ulp apart."""
    k = x.shape[-1]
    xs = x.reshape(-1, k)
    xs = xs.to(torch.bfloat16).float() if formulation == "split" else xs.float()
    mag = xs.abs() @ numerics.dequantize_int4(packed, scales, group).abs().t()
    bound = ((2 * k * 2.0**-24 + w_rel) * mag).reshape(y.shape)
    _, exp = torch.frexp(y.float().abs() + bound)
    ulp = torch.finfo(y.dtype).eps * torch.pow(2.0, (exp - 1).float())
    return bound + ulp


def weight_only_int4_matmul_ref(x, packed, scales, group=128, bias=None, out_dtype=None,
                                formulation="split"):
    """Plain version (same contract as :func:`weight_only_int4_matmul`),
    in the TPU kernel's order of operations across groups."""
    if formulation not in FORMULATIONS:
        raise ValueError(f"unknown wo4 formulation {formulation!r}")
    out_dtype = out_dtype or x.dtype
    k = x.shape[-1]
    n = packed.shape[0]
    xs = x.reshape(-1, k)
    if formulation == "legacy":
        y = xs.float() @ numerics.dequantize_int4(packed, scales, group).t()
    else:
        m, ng = xs.shape[0], k // group
        q = numerics.unpack_int4(packed, group).float()
        p = torch.einsum("gmk,gkn->gmn",
                         xs.to(torch.bfloat16).float().reshape(m, ng, group).transpose(0, 1),
                         q.reshape(n, ng, group).permute(1, 2, 0))  # [G, M, N]
        y = torch.zeros(m, n, dtype=torch.float32, device=x.device)
        for gi in range(ng):
            y = y + p[gi] * scales[:, gi]
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype).reshape(*x.shape[:-1], n)


def _launch(fn_name: str, x, packed, scales, group, bias, out_dtype):
    out_dtype = out_dtype or x.dtype
    k = x.shape[-1]
    n, bias = check_int4_weight(fn_name, k, packed, scales, group, bias)
    if out_dtype not in _build.DTYPE_CODES:
        raise TypeError(f"{fn_name}: unsupported out_dtype {out_dtype}")
    x = x.contiguous()
    tensors = [x, packed, scales] + ([bias] if bias is not None else [])
    dev = _build.same_device_contiguous(fn_name, *tensors)
    if dev.type != "cuda":
        raise ValueError(f"{fn_name}: launches on CUDA tensors only, got {dev}")
    if x.data_ptr() % 16 or packed.data_ptr() % 16:
        raise ValueError(f"{fn_name}: x and packed must be 16-byte aligned")
    m = x.numel() // k
    out = torch.empty(*x.shape[:-1], n, dtype=out_dtype, device=dev)
    err = getattr(_build.lib(), fn_name)(
        x.data_ptr(), packed.data_ptr(), scales.data_ptr(),
        bias.data_ptr() if bias is not None else None, out.data_ptr(),
        _build.DTYPE_CODES[out_dtype], m, n, k, group, _build.stream_ptr(dev))
    _build.check(err, fn_name)
    return out


def wo4_split(x, packed, scales, group, bias=None, out_dtype=None):
    """Launch the split body on CUDA tensors; x must be bfloat16."""
    if x.dtype != torch.bfloat16:
        raise TypeError(f"wo4 split: x must be bfloat16, got {x.dtype}")
    out = _launch("pq_wo4_split", x, packed, scales, group, bias, out_dtype)
    wo4_split.launches += 1
    return out


def wo4_legacy(x, packed, scales, group, bias=None, out_dtype=None):
    """Launch the legacy body on CUDA tensors; x of any float type is
    widened to f32 (exactly) first."""
    if not x.is_floating_point():
        raise TypeError(f"wo4 legacy: x must be floating point, got {x.dtype}")
    out = _launch("pq_wo4_legacy", x.float(), packed, scales, group, bias,
                  out_dtype or x.dtype)
    wo4_legacy.launches += 1
    return out


wo4_split.launches = 0
wo4_legacy.launches = 0


def weight_only_int4_matmul(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
                            group: int = 128, bias: torch.Tensor | None = None,
                            out_dtype=None, formulation: str = "split") -> torch.Tensor:
    """y = x @ dequant_int4(packed, scales)^T + bias, cast to ``out_dtype``
    (default x.dtype).

    x [..., K] (bf16 on CUDA for ``split``); packed int8 [N, K/2]; scales f32
    [N, K/group]; bias f32 [N] or None. On CUDA, group is one of
    ``CUDA_GROUPS``.
    """
    if formulation not in FORMULATIONS:
        raise ValueError(f"unknown wo4 formulation {formulation!r}")
    if x.device.type == "cpu":
        return weight_only_int4_matmul_ref(x, packed, scales, group, bias, out_dtype,
                                           formulation)
    launch = wo4_split if formulation == "split" else wo4_legacy
    return launch(x, packed, scales, group, bias, out_dtype)
