"""The numerics contract and the quantized-tensor containers."""

from . import numerics
from .qtensor import QTensor, QTensor4

__all__ = ["numerics", "QTensor", "QTensor4"]
