"""Model conversion: walk a module tree and quantize its linears."""

from __future__ import annotations

from torch import nn

from .qlinear import QLinear


def quantize_model(model: nn.Module, mode: str = "dynamic", int4_group: int = 128,
                   int4_clip: str = "mse") -> nn.Module:
    """Convert every ``QLinear`` in mode ``fp`` to ``mode`` in place:
    ``dynamic`` (per-output-channel int8 weights, dynamic per-token int8
    activations), ``weight_only`` (the same weights, bf16 activations),
    ``weight_only_int4`` or ``dynamic_int4`` (group-wise int4 weights with
    group ``pick_int4_group(K, int4_group)`` and scales chosen by
    ``int4_clip``, "mse" or "amax"; bf16 or dynamic int8 activations).
    Returns the model."""
    for module in model.modules():
        if isinstance(module, QLinear):
            module.quantize_(mode, int4_group=int4_group, int4_clip=int4_clip)
    return model
