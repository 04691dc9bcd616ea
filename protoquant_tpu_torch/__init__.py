"""protoquant_tpu_torch: the protoquant int8 / int4 serving path in PyTorch, with
hand-written CUDA kernels for Hopper (sm_90a).

A port of ``protoquant_tpu`` (JAX/Pallas), which stays the reference. The
layout mirrors it (``core/ ops/ nn/ models/ engine/ utils/``). This package
imports neither ``jax`` nor ``protoquant_tpu``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; on
the CPU every kernel wrapper takes its plain PyTorch version.
"""

from .core import QTensor, QTensor4, numerics
from .engine import Engine, EngineConfig
from .models import BF16KVCache, LlamaModel, MixedKVCache, greedy_generate, params_from_numpy
from .nn import QLinear, quantize_model
from .utils import ModelConfig

__all__ = ["BF16KVCache", "Engine", "EngineConfig", "LlamaModel", "MixedKVCache",
           "ModelConfig", "QLinear", "QTensor", "QTensor4", "greedy_generate", "numerics",
           "params_from_numpy", "quantize_model"]
