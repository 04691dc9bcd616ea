"""QLinear: linear layer in mode ``fp``, ``dynamic``, ``weight_only``,
``weight_only_int4`` or ``dynamic_int4``.

* ``fp``:               y = x @ W^T + b in the activation dtype (the
                        unquantized baseline, and the layer before
                        conversion).
* ``dynamic``:          rowquant(x) -> int8 x int8 GEMM -> fused f32
                        epilogue, with per-output-channel int8 weights.
* ``weight_only``:      bf16(x) x int8 W with an f32 sum, the
                        per-output-channel scale and bias in the f32
                        epilogue. x is rounded to bf16 whatever the model's
                        dtype, as the JAX model's ``weight_only_matmul_xla``
                        does on every backend.
* ``weight_only_int4``: bf16(x) x group-wise int4 W, the TPU kernel's
                        ``split`` formulation (exact codes, the group scale on
                        each group's f32 partial sum). The JAX model's default
                        (``LINEAR_BACKEND="auto"``) runs an XLA formulation
                        that rounds each weight q * s to bf16 first, a
                        different function; the port computes what the
                        Pallas kernel computes.
* ``dynamic_int4``:     rowquant(x) -> W4A8 GEMM (int8 activations x int4
                        weights on the int8 tensor cores), formulation from
                        ``ops.resolve_w4a8_formulation()``.

Tensor parallelism (``psum_axis``, the mesh's ``RankGroup`` of the model
axis; the JAX layer takes the axis name): a row-parallel layer holds its
K/tp slice of the weight, reduces its f32 product over the ranks (in rank
order) and adds its bias after the reduction; with ``collective`` (mode
``dynamic``) the reduction is the ring of
``parallel.collective.dynamic_qlinear_collective``. Modes ``fp`` and
``dynamic`` only.

The weight is stored [N, K] = [out_features, in_features] (the ``nn.Linear``
layout, K contiguous); the JAX package stores [K, N]
(``models.from_jax.params_from_numpy`` transposes). The int4 modes hold
``qweight`` int8 [N, K/2] (two codes per byte, packed along K) and
``qscale`` f32 [N, K/group].
"""

from __future__ import annotations

import math

import torch
from torch import nn

from .. import ops
from ..core import numerics
from ..utils.device import resolve_device

MODES = ("fp", "dynamic", "weight_only", "weight_only_int4", "dynamic_int4")
INT4_MODES = ("weight_only_int4", "dynamic_int4")


def pick_int4_group(k: int, want: int = 128) -> int:
    """Largest even group <= want that divides K (small models, odd K)."""
    g = math.gcd(k, want)
    if g % 2:
        g = math.gcd(k, 2 * want)
        if g % 2:
            raise ValueError(f"in_features={k} cannot form an even int4 group")
    return g


class QLinear(nn.Module):
    def __init__(self, in_features: int, out_features: int, mode: str = "dynamic",
                 bias: bool = False, dtype=torch.bfloat16, device=None,
                 int4_group: int = 128, psum_axis=None, collective: bool = False):
        super().__init__()
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r}; ported modes are {MODES}")
        if psum_axis is not None and mode not in ("fp", "dynamic"):
            raise NotImplementedError(f"a row-parallel {mode} layer is not ported yet")
        # row-parallel reduction over this rank group, through the ring
        # collective matmul under ``collective`` (mode dynamic)
        self.psum_axis, self.collective = psum_axis, collective
        self.in_features, self.out_features = in_features, out_features
        self.mode = mode
        self.dtype = dtype
        self.int4_group = int4_group
        self.group = None
        device = resolve_device(device)
        if mode == "fp":
            self.weight = nn.Parameter(torch.empty(
                out_features, in_features, dtype=torch.float32, device=device),
                requires_grad=False)
        elif mode in INT4_MODES:
            self.group = pick_int4_group(in_features, int4_group)
            self._set_buffers(
                torch.zeros(out_features, in_features // 2, dtype=torch.int8, device=device),
                torch.ones(out_features, in_features // self.group, dtype=torch.float32,
                           device=device))
        else:
            self._set_buffers(
                torch.zeros(out_features, in_features, dtype=torch.int8, device=device),
                torch.ones(out_features, dtype=torch.float32, device=device))
        if bias:
            self.bias = nn.Parameter(torch.zeros(
                out_features, dtype=torch.float32, device=device), requires_grad=False)
        else:
            self.bias = None

    def _set_buffers(self, qweight: torch.Tensor, qscale: torch.Tensor) -> None:
        self.register_buffer("qweight", qweight.contiguous())
        self.register_buffer("qscale", qscale.contiguous())
        self._refresh_two_level()

    def _refresh_two_level(self) -> None:
        """dynamic_int4: the two-level (r16, scol) of ``qscale``, made once
        per weight (not saved; remade whenever the weight changes)."""
        if self.mode == "dynamic_int4":
            r16, scol = ops.two_level_scales(self.qscale)
            self.register_buffer("r16", r16, persistent=False)
            self.register_buffer("scol", scol, persistent=False)

    def _load_from_state_dict(self, *args, **kwargs):
        super()._load_from_state_dict(*args, **kwargs)
        self._refresh_two_level()

    def _quantized(self, w: torch.Tensor, clip: str = "mse"):
        """(qweight, qscale) of an fp weight [N, K] in this layer's mode."""
        if self.mode in INT4_MODES:
            q, s = numerics.quantize_groupwise_int4(w, self.group, clip)
            return numerics.pack_int4(q, self.group), s
        return numerics.quantize_channelwise(w, dim=1)

    @torch.no_grad()
    def set_weight(self, w: torch.Tensor, int4_clip: str = "mse") -> None:
        """Load an fp weight [N, K]: copied (fp), quantized per output
        channel (the int8 modes) or per (channel, group) (the int4 modes,
        with ``int4_clip`` "mse" or "amax")."""
        if tuple(w.shape) != (self.out_features, self.in_features):
            raise ValueError(f"weight shape {tuple(w.shape)}, want "
                             f"{(self.out_features, self.in_features)}")
        if self.mode == "fp":
            self.weight.copy_(w)
            return
        q, s = self._quantized(w, int4_clip)
        self.qweight.copy_(q)
        self.qscale.copy_(s)
        self._refresh_two_level()

    @torch.no_grad()
    def quantize_(self, mode: str = "dynamic", int4_group: int | None = None,
                  int4_clip: str = "mse") -> None:
        """Convert an fp layer in place to a quantized mode: ``dynamic`` or
        ``weight_only`` (the same per-output-channel int8 weight), or
        ``weight_only_int4`` or ``dynamic_int4`` (the same group-wise int4
        weight; the group is ``pick_int4_group(K, int4_group)``, by default
        the layer's own ``int4_group``)."""
        if mode not in MODES or mode == "fp":
            raise ValueError(f"cannot quantize to mode {mode!r}")
        if self.mode == mode:
            return
        if self.mode != "fp":
            raise ValueError(f"layer is already in mode {self.mode!r}")
        if self.psum_axis is not None and mode != "dynamic":
            raise NotImplementedError(f"a row-parallel {mode} layer is not ported yet")
        w = self.weight
        del self.weight
        self.mode = mode
        if mode in INT4_MODES:
            self.int4_group = int4_group or self.int4_group
            self.group = pick_int4_group(self.in_features, self.int4_group)
        self._set_buffers(*self._quantized(w, int4_clip))

    def forward(self, x: torch.Tensor, prequantized=None) -> torch.Tensor:
        """``prequantized`` (modes ``dynamic``, ``dynamic_int4``): optional
        (xq int8, s_x) from a rowquant pass shared with sibling projections
        that read the same activation, or from a producer-fused kernel;
        ``x`` is then not read and may be None."""
        if x is not None:
            x = x.to(self.dtype)
        if self.psum_axis is not None:
            return self._row_parallel(x, prequantized)
        if self.mode == "fp":
            y = x @ self.weight.to(self.dtype).t()
            if self.bias is not None:
                y = y + self.bias.to(self.dtype)
            return y
        if self.mode == "weight_only":
            return ops.weight_only_matmul(x.to(torch.bfloat16), self.qweight, self.qscale,
                                          self.bias, out_dtype=self.dtype)
        if self.mode == "weight_only_int4":
            return ops.weight_only_int4_matmul(
                x.to(torch.bfloat16), self.qweight, self.qscale, self.group, self.bias,
                out_dtype=self.dtype, formulation="split")
        if prequantized is None:
            prequantized = ops.rowquant(x)
        xq, s_x = prequantized
        if self.mode == "dynamic_int4":
            return ops.w4a8_matmul(xq, s_x, self.qweight, self.qscale, self.group, self.bias,
                                   out_dtype=self.dtype,
                                   formulation=ops.resolve_w4a8_formulation(),
                                   two_level=(self.r16, self.scol))
        return ops.qmatmul(xq, self.qweight, s_x, self.qscale, self.bias,
                           out_dtype=self.dtype)

    def _row_parallel(self, x, prequantized):
        """This rank's K slice of a row-parallel product, reduced over the
        ranks; the bias joins after the reduction, in f32."""
        if self.mode == "fp":
            y = self.psum_axis.psum(x @ self.weight.to(self.dtype).t())
        elif self.collective:
            from ..parallel.collective import dynamic_qlinear_collective

            y = dynamic_qlinear_collective(x, self.qweight, self.qscale, self.psum_axis)
        else:
            xq, s_x = prequantized if prequantized is not None else ops.rowquant(x)
            y = self.psum_axis.psum(ops.qmatmul(xq, self.qweight, s_x, self.qscale,
                                                out_dtype=torch.float32))
        if self.bias is not None:
            y = y.float() + self.bias
        return y.to(self.dtype)

    def extra_repr(self) -> str:
        group = f", group={self.group}" if self.group else ""
        tp = (f", row-parallel over {self.psum_axis.size}"
              f"{' (collective)' if self.collective else ''}" if self.psum_axis else "")
        return (f"in_features={self.in_features}, out_features={self.out_features}, "
                f"mode={self.mode}{group}, bias={self.bias is not None}{tp}")
