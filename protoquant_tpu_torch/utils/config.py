"""Model and engine configs: the fields the Llama path reads.

Field names and defaults follow ``protoquant_tpu.utils.config`` so a config
carries across by name. The defaults are Llama-2-7B.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32  # fewer than heads => GQA
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    head_dim_override: int = 0

    def __post_init__(self):
        if self.num_attention_heads % self.num_key_value_heads:
            raise ValueError("num_attention_heads must divide by num_key_value_heads")

    @property
    def head_dim(self) -> int:
        return self.head_dim_override or (
            self.hidden_size // self.num_attention_heads)

    @classmethod
    def llama2_7b(cls) -> "ModelConfig":
        return cls()

    @classmethod
    def tiny(cls, vocab_size: int = 256) -> "ModelConfig":
        """2-layer d=512 toy config."""
        return cls(
            vocab_size=vocab_size,
            hidden_size=512,
            intermediate_size=1024,
            num_hidden_layers=2,
            num_attention_heads=8,
            num_key_value_heads=8,
            max_position_embeddings=512,
        )


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Continuous-batching engine config (int8 KV cache, dense or paged)."""

    max_batch_size: int = 8
    max_seq_len: int = 2048
    page_size: int = 128  # tokens per KV page (kv_layout="paged")
    prefill_chunk: int = 512
    max_new_tokens: int = 256
    temperature: float = 0.0  # 0 => greedy
    top_k: int = 0
    top_p: float = 1.0  # 1.0 => no nucleus truncation
    min_p: float = 0.0  # 0.0 => no min-p truncation
    return_logprobs: bool = False
    seed: int = 0
    # Block-level prefix caching (paged layout only): requests sharing a
    # prompt prefix adopt its resident KV pages and skip their prefill
    # (engine/prefix_cache.py).
    prefix_cache: bool = False
