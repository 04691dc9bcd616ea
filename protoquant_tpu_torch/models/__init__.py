"""The Llama decoder, its mixture-of-experts block, its dense KV caches
(bf16, int8, K8V4, K4V8, Int4), the ring int8 cache, and greedy
generation."""

from .from_jax import cache_from_numpy, params_from_numpy
from .generate import greedy_generate
from .kv_cache import (INT4_KV_GROUP, BF16KVCache, Int4KVCache, Int8KVCache, K4V8KVCache,
                       MixedKVCache, RingInt8KVCache, quantize_kv, quantize_kv4,
                       ring_positions)
from .llama import LlamaModel, init_cache
from .moe import MoEMLP

__all__ = ["BF16KVCache", "INT4_KV_GROUP", "Int4KVCache", "Int8KVCache", "K4V8KVCache",
           "LlamaModel", "MixedKVCache", "MoEMLP", "RingInt8KVCache", "cache_from_numpy",
           "greedy_generate", "init_cache", "params_from_numpy", "quantize_kv", "quantize_kv4",
           "ring_positions"]
