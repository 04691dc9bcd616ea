"""Model, mesh and engine configs: the fields the Llama, Mistral, Gemma-2, BLOOM
and GPT-OSS paths read.

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
    # Kept for configs that carry it; lm_head is its own parameter either way,
    # as in the JAX model.
    tie_word_embeddings: bool = False
    # MLP activation: "silu" (Llama SwiGLU) | "gelu_tanh" (Gemma GeGLU) |
    # "gelu" (BLOOM; the tanh approximation too, as the JAX model maps it).
    hidden_act: str = "silu"
    # Gemma family: RMSNorm computes y * (1 + w) (weights stored zero-centred).
    rmsnorm_unit_offset: bool = False
    # Gemma family: scale embeddings by sqrt(hidden_size) after lookup.
    scale_embeddings: bool = False
    # Gemma-2 style final-logit soft-capping: cap * tanh(logits / cap); 0 = off.
    final_logit_softcap: float = 0.0
    # Head dim when it differs from hidden_size // heads (Gemma: 256). 0 = derive.
    head_dim_override: int = 0
    # Mistral-family sliding-window attention: each query attends to at most
    # the last `sliding_window` positions. 0 = full causal attention.
    sliding_window: int = 0
    # Gemma-2: the window applies only on even layers (odd layers full).
    alternating_sliding_window: bool = False
    # Every Nth layer global, the rest sliding: layer i slides iff (i+1) %
    # pattern != 0 (2 == Gemma-2's alternation; 0 = all layers sliding when
    # sliding_window > 0).
    sliding_window_pattern: int = 0
    # Gemma-2: attention scores scaled by query_pre_attn_scalar^-0.5 instead
    # of head_dim^-0.5 (0 = default head_dim scaling).
    query_pre_attn_scalar: float = 0.0
    # Gemma-2: attention-logit soft-capping cap*tanh(s/cap) pre-mask (0=off).
    attn_logit_softcap: float = 0.0
    # Gemma-2 sandwich norms: post-attention norm on the attention OUTPUT,
    # plus pre/post-feedforward norms around the MLP.
    sandwich_norms: bool = False
    # "rmsnorm" | "layernorm" (mean-centred, with a bias: BLOOM).
    norm_type: str = "rmsnorm"
    # False: a plain 2-layer MLP, up_proj -> act -> down_proj (BLOOM).
    mlp_gated: bool = True
    # Biases on the MLP projections, on q/k/v, and on o_proj.
    mlp_bias: bool = False
    attention_bias: bool = False
    attention_out_bias: bool = False
    # "rope" | "alibi" (BLOOM: rope-free, per-head linear distance biases
    # on the attention logits, slopes from the head count).
    position_embedding: str = "rope"
    # BLOOM: a LayerNorm on the token embedding output.
    embedding_layernorm: bool = False
    # GPT-OSS: a learned logit per head joins every softmax and carries no
    # value (its probability mass is dropped).
    learned_attention_sinks: bool = False
    # Mixture of experts (0 = the dense MLP): experts, the top-k each token
    # takes, the GShard capacity factor, the expert FFN width (0 =
    # intermediate_size), top-k weights normalized to sum 1, a multiplier
    # on them, and the first K layers kept dense.
    num_local_experts: int = 0
    num_experts_per_tok: int = 2
    expert_capacity_factor: float = 1.25
    moe_intermediate_size: int = 0
    moe_norm_topk: bool = True
    routed_scaling_factor: float = 1.0
    first_k_dense_replace: int = 0
    # "mixtral" (w1/w3/w2 SwiGLU) or "gpt_oss" (fused interleaved gate_up
    # with biases, clamped glu); a biased router; GPT-OSS routing: top-k on
    # the raw logits, then softmax over the k chosen.
    moe_variant: str = "mixtral"
    moe_router_bias: bool = False
    moe_softmax_after_topk: bool = False
    # DeepSeek routing: not ported (they wait for MLA); kept so a JAX config
    # carries across by name, and refused when set.
    moe_score_func: str = "softmax"
    moe_gate_bias: bool = False
    n_group: int = 0
    topk_group: int = 0
    n_shared_experts: int = 0
    # RoPE scaling: "" (none) or "yarn" (ramped interpolation between the
    # beta_fast / beta_slow correction dims, with an attention factor on
    # cos and sin; truncate floors and ceils the correction range).
    rope_scaling_type: str = ""
    rope_scaling_factor: float = 8.0
    rope_scaling_original_max_position_embeddings: int = 8192
    rope_scaling_beta_fast: float = 32.0
    rope_scaling_beta_slow: float = 1.0
    rope_scaling_mscale: float = 0.0  # 0 = unset
    rope_scaling_mscale_all_dim: float = 0.0  # 0 = unset
    rope_scaling_truncate: bool = True

    def __post_init__(self):
        if self.num_attention_heads % self.num_key_value_heads:
            raise ValueError("num_attention_heads must divide by num_key_value_heads")
        if self.hidden_act not in ("silu", "gelu_tanh", "gelu"):
            raise ValueError(f"hidden_act {self.hidden_act!r}: the port has 'silu', "
                             "'gelu_tanh' and 'gelu'")
        if self.norm_type not in ("rmsnorm", "layernorm"):
            raise ValueError("norm_type must be 'rmsnorm' or 'layernorm'")
        if self.position_embedding not in ("rope", "alibi"):
            raise ValueError(f"position_embedding {self.position_embedding!r}: the port "
                             "has 'rope' and 'alibi'")
        if self.rope_scaling_type not in ("", "yarn"):
            raise ValueError(f"rope_scaling_type {self.rope_scaling_type!r}: the port has "
                             "'' and 'yarn'")
        if self.moe_variant not in ("mixtral", "gpt_oss"):
            raise ValueError(f"moe_variant {self.moe_variant!r}: the port has 'mixtral' "
                             "and 'gpt_oss'")
        deepseek = {"moe_score_func": self.moe_score_func != "softmax",
                    "moe_gate_bias": self.moe_gate_bias,
                    "n_group/topk_group": self.n_group > 1 or self.topk_group > 0,
                    "n_shared_experts": self.n_shared_experts > 0}
        if any(deepseek.values()):
            raise ValueError(f"DeepSeek routing {[k for k, v in deepseek.items() if v]} is "
                             "not ported")

    @property
    def is_moe(self) -> bool:
        return self.num_local_experts > 0

    def layer_is_moe(self, layer_idx: int) -> bool:
        """Whether layer ``layer_idx`` takes the MoE block: the first
        ``first_k_dense_replace`` layers keep the dense MLP."""
        return self.is_moe and layer_idx >= self.first_k_dense_replace

    def layer_window(self, layer_idx: int) -> int:
        """The sliding window of layer ``layer_idx`` (0 = full causal), as
        ``protoquant_tpu/models/llama.py:Attention`` picks it."""
        pattern = self.sliding_window_pattern or (2 if self.alternating_sliding_window else 0)
        sliding = self.sliding_window > 0 and (pattern == 0 or bool((layer_idx + 1) % pattern))
        return self.sliding_window if sliding else 0

    @property
    def head_dim(self) -> int:
        return self.head_dim_override or (
            self.hidden_size // self.num_attention_heads)

    @classmethod
    def llama2_7b(cls) -> "ModelConfig":
        return cls()

    @classmethod
    def mistral_7b(cls) -> "ModelConfig":
        return cls(
            vocab_size=32000,
            hidden_size=4096,
            intermediate_size=14336,
            num_hidden_layers=32,
            num_attention_heads=32,
            num_key_value_heads=8,
            max_position_embeddings=32768,
            rms_norm_eps=1e-5,
            rope_theta=10000.0,
            sliding_window=4096,
        )

    @classmethod
    def gemma2_9b(cls) -> "ModelConfig":
        return cls(
            vocab_size=256000,
            hidden_size=3584,
            intermediate_size=14336,
            num_hidden_layers=42,
            num_attention_heads=16,
            num_key_value_heads=8,
            max_position_embeddings=8192,
            rms_norm_eps=1e-6,
            tie_word_embeddings=True,
            hidden_act="gelu_tanh",
            rmsnorm_unit_offset=True,
            scale_embeddings=True,
            head_dim_override=256,
            sliding_window=4096,
            alternating_sliding_window=True,
            query_pre_attn_scalar=256.0,
            attn_logit_softcap=50.0,
            final_logit_softcap=30.0,
            sandwich_norms=True,
        )

    @classmethod
    def bloom_560m(cls) -> "ModelConfig":
        """BLOOM-560m: ALiBi positions (rope-free), an embedding LayerNorm,
        biased LayerNorms and projections, a plain gelu MLP, tied head."""
        return cls(
            vocab_size=250880,
            hidden_size=1024,
            intermediate_size=4096,
            num_hidden_layers=24,
            num_attention_heads=16,
            num_key_value_heads=16,
            max_position_embeddings=2048,
            norm_type="layernorm",
            mlp_gated=False,
            mlp_bias=True,
            attention_bias=True,
            attention_out_bias=True,
            hidden_act="gelu",
            position_embedding="alibi",
            embedding_layernorm=True,
            tie_word_embeddings=True,
        )

    @classmethod
    def gpt_oss_20b(cls) -> "ModelConfig":
        """GPT-OSS-20B: GQA 64/8 at Dh 64 with learned attention sinks and
        biases on q/k/v/o, a window of 128 on alternate layers, untruncated
        yarn, and 32 experts (top 4) of the fused interleaved clamped-glu
        kind behind a biased router with softmax after top-k."""
        return cls(
            vocab_size=201088,
            hidden_size=2880,
            intermediate_size=2880,
            num_hidden_layers=24,
            num_attention_heads=64,
            num_key_value_heads=8,
            max_position_embeddings=131072,
            rms_norm_eps=1e-5,
            rope_theta=150000.0,
            head_dim_override=64,
            sliding_window=128,
            alternating_sliding_window=True,
            attention_bias=True,
            attention_out_bias=True,
            learned_attention_sinks=True,
            num_local_experts=32,
            num_experts_per_tok=4,
            moe_variant="gpt_oss",
            moe_router_bias=True,
            moe_softmax_after_topk=True,
            rope_scaling_type="yarn",
            rope_scaling_factor=32.0,
            rope_scaling_beta_fast=32.0,
            rope_scaling_beta_slow=1.0,
            rope_scaling_truncate=False,
            rope_scaling_original_max_position_embeddings=4096,
        )

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
class MeshConfig:
    """Rank layout: ``dp`` replicas of ``tp`` tensor-parallel ranks, as
    ``protoquant_tpu.utils.config.MeshConfig`` (``parallel.make_mesh``)."""

    dp: int = 1
    tp: int = 1
    axis_names: tuple = ("data", "model")

    def __post_init__(self):
        object.__setattr__(self, "axis_names", tuple(self.axis_names))


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Continuous-batching engine config (int8 KV cache, dense, paged or
    ring)."""

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
    # Ring layout (kv_layout="ring"): the serving window of a model without
    # a trained one (0 = the model's sliding_window), and StreamingLLM
    # attention sinks: the first N positions stay visible to every query.
    stream_window: int = 0
    attention_sinks: int = 0
    # Block-level prefix caching (paged layout only): requests sharing a
    # prompt prefix adopt its resident KV pages and skip their prefill
    # (engine/prefix_cache.py).
    prefix_cache: bool = False
