"""QTensor: an int8 payload with per-channel f32 scales; QTensor4: packed
int4 codes with per-(channel, group) f32 scales. Both also hold a stack of
MoE expert weights [E, N, K], each expert quantized on its own."""

from __future__ import annotations

import dataclasses

import torch

from . import numerics


@dataclasses.dataclass
class QTensor:
    """int8 ``data`` and f32 ``scale`` reduced over ``axis`` of ``data``.

    A linear weight in the port is stored [N, K] (the ``nn.Linear`` layout,
    K contiguous) with per-output-channel scales [N], so ``axis`` is 1. A
    stack of expert weights [E, N, K] takes ``axis`` 2: per-expert,
    per-output-channel scales [E, N] (what the JAX package's ``QTensor``
    holds for [E, K, N] with axis 1).
    """

    data: torch.Tensor
    scale: torch.Tensor
    axis: int
    orig_dtype: torch.dtype = torch.float32

    @classmethod
    def quantize(cls, x: torch.Tensor, axis: int = 1) -> "QTensor":
        """Symmetric per-channel int8 quantization, reducing ``axis``."""
        axis = axis % x.ndim
        q, s = numerics.quantize_channelwise(x, dim=axis)
        return cls(data=q, scale=s, axis=axis, orig_dtype=x.dtype)

    @property
    def shape(self):
        return self.data.shape

    def dequantize(self) -> torch.Tensor:
        return numerics.dequantize(self.data, self.scale, self.axis).to(
            self.orig_dtype)

    def nbytes(self) -> int:
        return (self.data.numel() * self.data.element_size()
                + self.scale.numel() * self.scale.element_size())


@dataclasses.dataclass
class QTensor4:
    """Group-wise int4 weight: ``data`` int8 [N, K/2], two codes per byte
    packed along K (``numerics.pack_int4``: within each group, byte j holds
    k = j low and k = j + group/2 high), ``scale`` f32 [N, K/group]. A
    stack of expert weights [E, N, K] packs each expert along its own K:
    ``data`` [E, N, K/2], ``scale`` [E, N, K/group] (the JAX package's [E,
    K/2, N] and [E, K/group, N], transposed per expert).

    The port stores the byte-packed layout only. The JAX package's
    ``storage="native"`` is XLA's s4 dtype, which only its XLA formulation
    reads; here it raises ``ValueError``.
    """

    data: torch.Tensor
    scale: torch.Tensor
    group: int
    orig_k: int
    orig_dtype: torch.dtype = torch.float32

    @classmethod
    def quantize(cls, w: torch.Tensor, group: int = 128, storage: str = "packed",
                 clip: str = "mse") -> "QTensor4":
        """Quantize a 2-D [N, K] weight, or a 3-D [E, N, K] stack of expert
        weights expert by expert (K the contraction axis)."""
        if storage != "packed":
            raise ValueError(f"int4 storage {storage!r} is not ported; the port "
                             "stores the byte-packed layout only")
        if w.ndim == 3:
            parts = [cls.quantize(we, group, storage, clip) for we in w]
            return cls(data=torch.stack([p.data for p in parts]),
                       scale=torch.stack([p.scale for p in parts]), group=group,
                       orig_k=w.shape[2], orig_dtype=w.dtype)
        if w.ndim != 2:
            raise ValueError(f"QTensor4 takes a [N, K] or [E, N, K] weight, got "
                             f"{tuple(w.shape)}")
        q, s = numerics.quantize_groupwise_int4(w, group=group, clip=clip)
        return cls(data=numerics.pack_int4(q, group), scale=s, group=group,
                   orig_k=w.shape[1], orig_dtype=w.dtype)

    @property
    def shape(self):
        return (*self.data.shape[:-1], self.orig_k)

    def dequantize(self) -> torch.Tensor:
        if self.data.ndim == 3:
            w = torch.stack([numerics.dequantize_int4(d, s, self.group)
                             for d, s in zip(self.data, self.scale)])
        else:
            w = numerics.dequantize_int4(self.data, self.scale, self.group)
        return w.to(self.orig_dtype)

    def nbytes(self) -> int:
        return self.data.numel() + self.scale.numel() * self.scale.element_size()
