"""QLinear: linear layer in mode ``fp``, ``dynamic`` or ``weight_only``.

* ``fp``:          y = x @ W^T + b in the activation dtype (the unquantized
                   baseline, and the layer before conversion).
* ``dynamic``:     rowquant(x) -> int8 x int8 GEMM -> fused f32 epilogue,
                   with per-output-channel int8 weights.
* ``weight_only``: bf16(x) x int8 W with an f32 sum, the per-output-channel
                   scale and bias in the f32 epilogue. x is rounded to bf16
                   whatever the model's dtype, as the JAX model's
                   ``weight_only_matmul_xla`` does on every backend.

The weight is stored [N, K] = [out_features, in_features] (the ``nn.Linear``
layout, K contiguous); the JAX package stores [K, N]
(``models.from_jax.params_from_numpy`` transposes).
"""

from __future__ import annotations

import torch
from torch import nn

from .. import ops
from ..core import numerics

MODES = ("fp", "dynamic", "weight_only")


class QLinear(nn.Module):
    def __init__(self, in_features: int, out_features: int, mode: str = "dynamic",
                 bias: bool = False, dtype=torch.bfloat16, device=None):
        super().__init__()
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r}; ported modes are {MODES}")
        self.in_features, self.out_features = in_features, out_features
        self.mode = mode
        self.dtype = dtype
        if mode == "fp":
            self.weight = nn.Parameter(torch.empty(
                out_features, in_features, dtype=torch.float32, device=device),
                requires_grad=False)
        else:
            self.register_buffer("qweight", torch.zeros(
                out_features, in_features, dtype=torch.int8, device=device))
            self.register_buffer("qscale", torch.ones(
                out_features, dtype=torch.float32, device=device))
        if bias:
            self.bias = nn.Parameter(torch.zeros(
                out_features, dtype=torch.float32, device=device), requires_grad=False)
        else:
            self.bias = None

    @torch.no_grad()
    def set_weight(self, w: torch.Tensor) -> None:
        """Load an fp weight [N, K]: copied (fp) or quantized per output
        channel (the int8 modes)."""
        if tuple(w.shape) != (self.out_features, self.in_features):
            raise ValueError(f"weight shape {tuple(w.shape)}, want "
                             f"{(self.out_features, self.in_features)}")
        if self.mode == "fp":
            self.weight.copy_(w)
        else:
            q, s = numerics.quantize_channelwise(w, dim=1)
            self.qweight.copy_(q)
            self.qscale.copy_(s)

    @torch.no_grad()
    def quantize_(self, mode: str = "dynamic") -> None:
        """Convert an fp layer in place to an int8 mode (``dynamic`` or
        ``weight_only``: the same per-output-channel int8 weight)."""
        if mode not in MODES or mode == "fp":
            raise ValueError(f"cannot quantize to mode {mode!r}")
        if self.mode == mode:
            return
        if self.mode != "fp":
            raise ValueError(f"layer is already in mode {self.mode!r}")
        w = self.weight
        del self.weight
        q, s = numerics.quantize_channelwise(w, dim=1)
        self.register_buffer("qweight", q.contiguous())
        self.register_buffer("qscale", s.contiguous())
        self.mode = mode

    def forward(self, x: torch.Tensor, prequantized=None) -> torch.Tensor:
        """``prequantized`` (mode ``dynamic``): optional (xq int8, s_x) from
        a rowquant pass shared with sibling projections that read the same
        activation."""
        x = x.to(self.dtype)
        if self.mode == "fp":
            y = x @ self.weight.to(self.dtype).t()
            if self.bias is not None:
                y = y + self.bias.to(self.dtype)
            return y
        if self.mode == "weight_only":
            return ops.weight_only_matmul(x.to(torch.bfloat16), self.qweight, self.qscale,
                                          self.bias, out_dtype=self.dtype)
        if prequantized is None:
            prequantized = ops.rowquant(x)
        xq, s_x = prequantized
        return ops.qmatmul(xq, self.qweight, s_x, self.qscale, self.bias,
                           out_dtype=self.dtype)

    def extra_repr(self) -> str:
        return (f"in_features={self.in_features}, out_features={self.out_features}, "
                f"mode={self.mode}, bias={self.bias is not None}")
