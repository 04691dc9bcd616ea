"""Producer ops fused with dynamic per-row int8 quantization: kernels and
plain versions.

  rms_norm_quant(x, w, eps)    RMSNorm -> cast -> rowquant
  swiglu_quant(gate, up, act)  act(gate) * up -> rowquant (SwiGLU, GeGLU)

The kernels (``csrc/fused_quant.cu``) replace the Pallas kernels
``protoquant_tpu/ops/fused_quant.py:_rms_norm_quant_kernel`` and
``_swiglu_quant_kernel``: they read the producer's inputs once and emit the
int8 codes and scales the next dynamic projections read, so the normed or
gated activation is never written. Each plain version is the module
composition it replaces (``rms_norm`` and ``swiglu`` below, which the
model's unfused path runs, then ``core.numerics.quantize_rowwise``), so on
the CPU the fused model equals the unfused one bit for bit.

On the card the kernels sum in another order than PyTorch's reductions and
compute the activation with their own instructions, so a code may move by
one step where a value sits on a rounding boundary; the quantizer itself is
the contract's (IEEE division, round half to even, clamp +-127). The JAX
package demands of its kernels: codes equal or +-1, the norm's in under
1e-3 of the elements with scales within rtol 1e-6, the gate's in under 5 %
with scales within rtol 1e-2 (``protoquant_tpu/ops/fused_quant.py``).

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises. rms_norm_quant takes one row per block. swiglu_quant holds each row
in registers and takes ``ops.rowquant``'s plan: a row over
a thread block cluster where rows are few (route "cluster"), a block a row
where they are many (route "rows"), counted in ``swiglu_quant.routes``;
:func:`swiglu_quant_parts_ref` spells its cut of a row out.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core import numerics
from . import _build
from .rowquant import (RowPlan, check_width, part_maxima, quantize_parts, row_slices,
                       rowquant_plan)

# rms_norm_quant keeps one f32 row in shared memory (226 KB of a block's 227).
_MAX_K = 226 * 1024 // 4
_ACT_CODES = {"silu": 0, "gelu": 1}


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float,
             cast_dtype=torch.bfloat16) -> torch.Tensor:
    """RMSNorm in f32, cast to ``cast_dtype``: ``(x * rsqrt(mean(x^2) +
    eps)) * w``, w the f32 effective weight [K]."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(cast_dtype)


def activation(act: str):
    if act == "silu":
        return F.silu
    if act == "gelu":  # tanh approximation (Gemma)
        return lambda v: F.gelu(v, approximate="tanh")
    raise ValueError(f"unknown activation {act!r}; expected 'silu' or 'gelu'")


def swiglu(gate: torch.Tensor, up: torch.Tensor, act: str = "silu",
           cast_dtype=torch.bfloat16) -> torch.Tensor:
    """The gated MLP's product: ``act(gate in f32)`` cast to ``cast_dtype``,
    times ``up`` in ``cast_dtype`` (one rounding of the product)."""
    return activation(act)(gate.float()).to(cast_dtype) * up.to(cast_dtype)


def rms_norm_quant_ref(x, w, *, eps: float, cast_dtype=torch.bfloat16):
    """Plain version: ``quantize_rowwise(rms_norm(x, w, eps, cast_dtype))``."""
    return numerics.quantize_rowwise(rms_norm(x, w, eps, cast_dtype))


def swiglu_quant_ref(gate, up, *, act: str = "silu", cast_dtype=torch.bfloat16):
    """Plain version: ``quantize_rowwise(swiglu(gate, up, act, cast_dtype))``."""
    return numerics.quantize_rowwise(swiglu(gate, up, act, cast_dtype))


def swiglu_quant_parts_ref(gate, up, plan: RowPlan, *, act: str = "silu",
                           cast_dtype=torch.bfloat16, head: int = 0):
    """The kernel's cut of each row in plain PyTorch: the producer's h
    (:func:`swiglu`), then each slice's maximum (``ops.rowquant.row_slices``
    of ``plan.blocks`` and ``head``, by gate's dtype), the maximum of those,
    each slice quantized. Equal to :func:`swiglu_quant_ref` bit for bit at
    any plan."""
    h = swiglu(gate, up, act, cast_dtype)
    slices = row_slices(gate.shape[-1], plan.blocks, gate.element_size(), head)
    return quantize_parts(h, part_maxima(h, slices), slices)


def _check_cast(name: str, cast_dtype) -> int:
    if cast_dtype not in _build.DTYPE_CODES:
        raise TypeError(f"{name}: unsupported cast_dtype {cast_dtype}")
    return _build.DTYPE_CODES[cast_dtype]


def _check_width(name: str, k: int) -> None:
    if not 0 < k <= _MAX_K:
        raise ValueError(f"{name}: K={k} outside (0, {_MAX_K}]")


def rms_norm_quant(x: torch.Tensor, w: torch.Tensor, *, eps: float,
                   cast_dtype=torch.bfloat16):
    """RMSNorm fused with per-token int8 quantization.

    x [..., K] (f32, bf16 or f16); w [K], the effective norm weight (used in
    f32). Returns (xq int8 [..., K], s_x f32 [...])."""
    if x.device.type == "cpu":
        return rms_norm_quant_ref(x, w, eps=eps, cast_dtype=cast_dtype)
    if x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"rms_norm_quant: unsupported dtype {x.dtype}")
    cast = _check_cast("rms_norm_quant", cast_dtype)
    k = x.shape[-1]
    _check_width("rms_norm_quant", k)
    if w.shape != (k,):
        raise ValueError(f"rms_norm_quant: w shape {tuple(w.shape)}, want ({k},)")
    x, w = x.contiguous(), w.float().contiguous()
    dev = _build.same_device_contiguous("rms_norm_quant", x, w)
    m = x.numel() // k
    xq = torch.empty(x.shape, dtype=torch.int8, device=dev)
    sx = torch.empty(x.shape[:-1], dtype=torch.float32, device=dev)
    if m == 0:
        return xq, sx
    err = _build.lib().pq_rms_norm_quant(
        x.data_ptr(), _build.DTYPE_CODES[x.dtype], w.data_ptr(), xq.data_ptr(),
        sx.data_ptr(), m, k, float(eps), cast, _build.stream_ptr(dev))
    _build.check(err, "pq_rms_norm_quant")
    rms_norm_quant.launches += 1
    return xq, sx


def swiglu_quant_launch(gate: torch.Tensor, up: torch.Tensor, *, act: str = "silu",
                        cast_dtype=torch.bfloat16, plan: RowPlan | None = None):
    """Launch the kernel on CUDA tensors with ``plan`` (None: the plan's);
    returns (hq, s_h, plan). Counts nothing (:func:`swiglu_quant` counts)."""
    if act not in _ACT_CODES:
        raise ValueError(f"swiglu_quant: unknown activation {act!r}")
    if gate.dtype not in _build.DTYPE_CODES or up.dtype != gate.dtype:
        raise TypeError(f"swiglu_quant: gate {gate.dtype} and up {up.dtype} must be "
                        "one of float32, bfloat16, float16")
    if up.shape != gate.shape:
        raise ValueError(f"swiglu_quant: shapes gate {tuple(gate.shape)}, up "
                         f"{tuple(up.shape)}")
    cast = _check_cast("swiglu_quant", cast_dtype)
    k = gate.shape[-1]
    check_width("swiglu_quant", k)
    gate, up = gate.contiguous(), up.contiguous()
    dev = _build.same_device_contiguous("swiglu_quant", gate, up)
    m = gate.numel() // k
    hq = torch.empty(gate.shape, dtype=torch.int8, device=dev)
    sh = torch.empty(gate.shape[:-1], dtype=torch.float32, device=dev)
    if m == 0:
        return hq, sh, None
    plan = plan or rowquant_plan(m, k, gate.element_size())
    err = _build.lib().pq_swiglu_quant(
        gate.data_ptr(), up.data_ptr(), _build.DTYPE_CODES[gate.dtype], hq.data_ptr(),
        sh.data_ptr(), m, k, plan.blocks, plan.threads, plan.vectors, _ACT_CODES[act], cast,
        _build.stream_ptr(dev))
    _build.check(err, "pq_swiglu_quant")
    return hq, sh, plan


def swiglu_quant(gate: torch.Tensor, up: torch.Tensor, *, act: str = "silu",
                 cast_dtype=torch.bfloat16):
    """``act(gate) * up`` fused with per-token int8 quantization.

    gate, up [..., I] of one dtype (f32, bf16 or f16); act "silu" or "gelu"
    (tanh approximation). Returns (hq int8 [..., I], s_h f32 [...])."""
    if gate.device.type == "cpu":
        return swiglu_quant_ref(gate, up, act=act, cast_dtype=cast_dtype)
    hq, sh, plan = swiglu_quant_launch(gate, up, act=act, cast_dtype=cast_dtype)
    if plan is not None:
        swiglu_quant.launches += 1
        swiglu_quant.routes[plan.route] += 1
    return hq, sh


rms_norm_quant.launches = 0
swiglu_quant.launches = 0
# launches by route, as rowquant's: "cluster", "rows"
swiglu_quant.routes = {"cluster": 0, "rows": 0}
