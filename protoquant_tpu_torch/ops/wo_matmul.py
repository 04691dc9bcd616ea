"""Weight-only int8 matmul: bf16 activations times int8 weights, with the
per-output-channel scale in the f32 epilogue. Kernel and plain version.

The kernel (``csrc/wo_matmul.cu``) replaces the Pallas kernel
``protoquant_tpu/ops/wo_matmul.py:_wo_kernel``. Both versions compute what
the JAX model computes on every backend (``weight_only_matmul_xla``): x is
rounded to bf16, each product bf16 x int8 is exact in f32 and summed in
f32, then ``y = acc * s_w + b`` (f32, a separate multiply and add), cast to
``out_dtype``. The int8 weight is [N, K] (the ``nn.Linear`` layout). The
kernel takes bf16 x only; a CPU tensor takes the plain version, a CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from . import _build


def weight_only_tolerance(x, wq, s_w, y):
    """How far two correct versions of the product may differ at each
    output ``y``: the products are exact, so only the order of the f32 sum
    differs, by at most ``K * 2**-24 * sum_k |x * w| * s_w``; then the cast
    to ``y.dtype`` may round the two sums one ulp apart."""
    k = x.shape[-1]
    mag = (x.reshape(-1, k).to(torch.bfloat16).float().abs()
           @ wq.float().abs().t()) * s_w.float()[None, :]
    sum_bound = (k * 2.0**-24) * mag.reshape(y.shape)
    _, exp = torch.frexp(y.float().abs() + sum_bound)
    ulp = torch.finfo(y.dtype).eps * torch.pow(2.0, (exp - 1).float())
    return sum_bound + ulp


def weight_only_matmul_ref(x, wq, s_w, bias=None, out_dtype=None):
    """Plain version (same contract as :func:`weight_only_matmul`)."""
    out_dtype = out_dtype or x.dtype
    k = x.shape[-1]
    acc = x.reshape(-1, k).to(torch.bfloat16).float() @ wq.float().t()
    y = acc * s_w.float()[None, :]
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype).reshape(*x.shape[:-1], wq.shape[0])


def weight_only_matmul(x: torch.Tensor, wq: torch.Tensor, s_w: torch.Tensor,
                       bias: torch.Tensor | None = None, out_dtype=None) -> torch.Tensor:
    """y = (bf16(x) @ wq^T) * s_w + bias with an f32 sum, cast to
    ``out_dtype`` (default x.dtype).

    x [..., K] (bf16 on CUDA); wq int8 [N, K]; s_w f32 [N]; bias f32 [N] or
    None. K must be a multiple of 16 on CUDA.
    """
    if x.device.type == "cpu":
        return weight_only_matmul_ref(x, wq, s_w, bias, out_dtype)
    out_dtype = out_dtype or x.dtype
    n, k = wq.shape
    if x.shape[-1] != k or s_w.shape != (n,):
        raise ValueError(f"weight_only_matmul: shapes x {tuple(x.shape)}, wq "
                         f"{tuple(wq.shape)}, s_w {tuple(s_w.shape)}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"weight_only_matmul: x must be bfloat16, got {x.dtype}")
    if wq.dtype != torch.int8 or s_w.dtype != torch.float32:
        raise TypeError("weight_only_matmul: wq must be int8 and s_w float32")
    if out_dtype not in _build.DTYPE_CODES:
        raise TypeError(f"weight_only_matmul: unsupported out_dtype {out_dtype}")
    if k % 16:
        raise ValueError(f"weight_only_matmul: K={k} must be a multiple of 16")
    if bias is not None:
        if bias.shape != (n,):
            raise ValueError(f"weight_only_matmul: bias shape {tuple(bias.shape)}")
        bias = bias.float().contiguous()
    x = x.contiguous()
    tensors = [x, wq, s_w] + ([bias] if bias is not None else [])
    dev = _build.same_device_contiguous("weight_only_matmul", *tensors)
    if x.data_ptr() % 16 or wq.data_ptr() % 16:
        raise ValueError("weight_only_matmul: x and wq must be 16-byte aligned")
    m = x.numel() // k
    out = torch.empty(*x.shape[:-1], n, dtype=out_dtype, device=dev)
    err = _build.lib().pq_weight_only_matmul(
        x.data_ptr(), wq.data_ptr(), s_w.data_ptr(),
        bias.data_ptr() if bias is not None else None, out.data_ptr(),
        _build.DTYPE_CODES[out_dtype], m, n, k, _build.stream_ptr(dev))
    _build.check(err, "pq_weight_only_matmul")
    weight_only_matmul.launches += 1
    return out


weight_only_matmul.launches = 0
