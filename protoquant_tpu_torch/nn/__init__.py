"""Quantized layers and model conversion."""

from .convert import quantize_model
from .qlinear import QLinear, pick_int4_group

__all__ = ["QLinear", "pick_int4_group", "quantize_model"]
