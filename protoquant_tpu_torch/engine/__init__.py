"""Continuous-batching engine and sampling."""

from ..utils.config import EngineConfig
from .engine import Engine, Request
from .paged_kv import PagedInt8KVCache
from .prefix_cache import PrefixCache
from .sampling import sample_batched, token_logprob

__all__ = ["Engine", "EngineConfig", "PagedInt8KVCache", "PrefixCache", "Request",
           "sample_batched", "token_logprob"]
