"""int8 + scales -> float: kernel and plain version.

The kernel (``csrc/dequant.cu``) replaces the Pallas kernels
``protoquant_tpu/ops/dequant.py:_dequant_cols_kernel`` and
``_dequant_rows_kernel``, a pure bandwidth op. ``axis`` keeps the JAX
meaning, the axis the scale was reduced over: ``axis=0`` gives one scale
per column (indexed by the last axis, as a JAX [K, N] weight's s[N]),
``axis=1`` one scale per row (as activations' s[M]). Both versions compute
``q * s`` in f32 and round once to ``out_dtype``, so they agree exactly.

No engine or model path reaches it: ``QTensor.dequantize`` stays on
``core.numerics``, as the JAX ``QTensor`` does. A CPU tensor takes the
plain version; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from ..core import numerics
from . import _build


def _check(q: torch.Tensor, scale: torch.Tensor, axis: int) -> None:
    if q.ndim != 2:
        raise ValueError("dequant kernel expects 2D input")
    if axis not in (0, 1):
        raise ValueError(f"dequant: axis must be 0 or 1, got {axis}")
    want = q.shape[1] if axis == 0 else q.shape[0]
    if scale.numel() != want:
        raise ValueError(f"dequant: {scale.numel()} scales for axis {axis} of "
                         f"{tuple(q.shape)}, want {want}")


def dequant_ref(q: torch.Tensor, scale: torch.Tensor, axis: int,
                out_dtype=torch.float32) -> torch.Tensor:
    """Plain version: ``numerics.dequantize(q, scale, axis)`` cast to
    ``out_dtype``."""
    _check(q, scale, axis)
    return numerics.dequantize(q, scale.reshape(-1).float(), axis).to(out_dtype)


def dequant(q: torch.Tensor, scale: torch.Tensor, axis: int,
            out_dtype=torch.float32) -> torch.Tensor:
    """Dequantize 2-D int8 ``q`` [M, N] whose scale was reduced over
    ``axis``: s[N] for ``axis=0``, s[M] for ``axis=1``."""
    if q.device.type == "cpu":
        return dequant_ref(q, scale, axis, out_dtype)
    _check(q, scale, axis)
    if q.dtype != torch.int8:
        raise TypeError(f"dequant: q must be int8, got {q.dtype}")
    if out_dtype not in _build.DTYPE_CODES:
        raise TypeError(f"dequant: unsupported out_dtype {out_dtype}")
    # the kernel loads 16 codes, and 4 scales, with one 16-byte load
    q = q.contiguous()
    q = q.clone() if q.data_ptr() % 16 else q
    scale = scale.reshape(-1).float().contiguous()
    scale = scale.clone() if scale.data_ptr() % 16 else scale
    dev = _build.same_device_contiguous("dequant", q, scale)
    m, n = q.shape
    out = torch.empty(m, n, dtype=out_dtype, device=dev)
    if q.numel() == 0:
        return out
    err = _build.lib().pq_dequant(
        q.data_ptr(), scale.data_ptr(), out.data_ptr(), _build.DTYPE_CODES[out_dtype],
        m, n, int(axis == 0), _build.stream_ptr(dev))
    _build.check(err, "pq_dequant")
    dequant.launches += 1
    return out


dequant.launches = 0
