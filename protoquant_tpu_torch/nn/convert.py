"""Model conversion: walk a module tree and quantize its linears."""

from __future__ import annotations

from torch import nn

from .qlinear import QLinear


def quantize_model(model: nn.Module, mode: str = "dynamic") -> nn.Module:
    """Convert every ``QLinear`` in mode ``fp`` to ``mode`` in place:
    ``dynamic`` (per-output-channel int8 weights, dynamic per-token int8
    activations) or ``weight_only`` (the same weights, bf16 activations).
    Returns the model."""
    for module in model.modules():
        if isinstance(module, QLinear):
            module.quantize_(mode)
    return model
