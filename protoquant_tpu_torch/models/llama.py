"""Llama-family decoder: RMSNorm, RoPE, GQA attention and a gated MLP,
every projection a ``QLinear``; with the config's switches, Mistral (a
sliding window on every layer), Gemma-2 (GeGLU, zero-centred norm
weights, sandwich norms, the embedding normalizer, a sliding window on
alternate layers, the query_pre_attn_scalar score scale, attention and
final-logit softcaps), BLOOM (LayerNorm with a bias, an embedding
LayerNorm, biased projections, a plain gelu MLP, ALiBi instead of RoPE) and
GPT-OSS (learned attention sinks, yarn RoPE, biased q/k/v/o, a mixture of
experts in place of the MLP: ``models/moe.py``).

Module and parameter names follow the flax tree of the JAX package
(``embed_tokens``, ``layers_{i}.self_attn.{q,k,v,o}_proj``,
``layers_{i}.mlp.{gate,up,down}_proj``, ``layers_{i}.block_sparse_moe``,
``layers_{i}.self_attn.sinks``, ``layers_{i}.{input,
post_attention,pre_feedforward,post_feedforward}_layernorm``, ``norm``,
``lm_head``, ``embed_norm``), so ``models.from_jax.params_from_numpy``
carries weights across by name. The norms, RoPE and the activations
compute in f32 and cast back to the activation dtype, as the JAX model
does. Under ``ops.FUSED_QUANT == "on"`` a ``dynamic`` layer takes the JAX
model's producer-fused path: the norms that feed projections and the gate
emit the int8 activations of the projections that read them
(``ops.rms_norm_quant``, ``ops.swiglu_quant``). With sandwich norms no norm
is fused (the JAX gating: the MLP's input norm is
``pre_feedforward_layernorm`` and the attention's stays plain) and the gate
still is; with LayerNorm nothing is (no norm is an RMSNorm and the MLP has
no gate); on a MoE model only the input norm is (the experts quantize
their own dispatched input); the final norm before ``lm_head`` stays
unfused.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from .. import ops
from ..nn.qlinear import QLinear
from ..ops.fused_quant import activation, rms_norm, swiglu
from ..utils.config import ModelConfig
from ..utils.device import resolve_device
from .kv_cache import (BF16KVCache, Int4KVCache, Int8KVCache, K4V8KVCache, MixedKVCache,
                       mha_attention)
from .moe import MoEMLP, StackedWeight

# kv_dtype -> the dense cache class that holds it
KV_CACHES = {"bf16": BF16KVCache, "int8": Int8KVCache, "k8v4": MixedKVCache,
             "k4v8": K4V8KVCache, "int4": Int4KVCache}
# torch dtypes taken as kv_dtype, and the element type of a BF16KVCache
_DTYPE_KEYS = {torch.int8: "int8", torch.bfloat16: "bf16", torch.float32: "bf16"}


def kv_cache_class(kv_dtype=torch.bfloat16):
    """The dense cache class of ``kv_dtype``: torch.bfloat16, "bf16" or
    torch.float32 (``BF16KVCache``, unquantized, the JAX package's default),
    "int8" or torch.int8, "k8v4" (``MixedKVCache``), "k4v8" (the JAX CLI's
    --kv-bits 6) or "int4" (KIVI, --kv-bits 4)."""
    key = _DTYPE_KEYS.get(kv_dtype, kv_dtype) if isinstance(kv_dtype, torch.dtype) else kv_dtype
    if not isinstance(key, str) or key not in KV_CACHES:
        raise ValueError(f"kv_dtype {kv_dtype!r}: the port has {sorted(KV_CACHES)}, "
                         "torch.int8, torch.bfloat16 and torch.float32")
    return KV_CACHES[key]


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device=None,
               kv_dtype=torch.bfloat16, tp: int = 1) -> list:
    """One dense KV cache of ``kv_dtype`` per layer (``kv_cache_class``), on
    ``device`` (default cuda). The default is the JAX package's: a
    ``BF16KVCache`` in bf16; torch.float32 makes it f32. ``tp``: the caches
    of one tensor-parallel rank, KV/tp heads each (the bf16 and int8 caches
    only, in this slice)."""
    cls = kv_cache_class(kv_dtype)
    if tp > 1 and cls not in (BF16KVCache, Int8KVCache):
        raise NotImplementedError(f"kv_dtype {kv_dtype!r} under tensor parallelism is not "
                                  "ported yet (bf16 and int8 are)")
    if cfg.num_key_value_heads % tp:
        raise ValueError(f"{cfg.num_key_value_heads} KV heads do not split over tp={tp}")
    device = resolve_device(device)
    kw = {"device": device}
    if cls is BF16KVCache:
        kw["dtype"] = torch.float32 if kv_dtype is torch.float32 else torch.bfloat16
    return [cls.init(batch, max_seq, cfg.num_key_value_heads // tp, cfg.head_dim, **kw)
            for _ in range(cfg.num_hidden_layers)]


def rope_tables(head_dim: int, max_len: int, theta: float, cfg: ModelConfig | None = None,
                device=None):
    """cos/sin tables [max_len, head_dim // 2], f32. With ``cfg`` whose
    ``rope_scaling_type`` is "yarn", the YaRN scaling of
    ``protoquant_tpu/models/llama.py:rope_tables``: the inverse frequencies
    blend from extrapolated (fast dims) to interpolated by the factor (slow
    dims) along a linear ramp between the beta_fast and beta_slow
    correction dims (floored and ceiled under ``rope_scaling_truncate``),
    and cos and sin are multiplied by ``yarn_attention_factor(cfg)``."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    inv_freq = 1.0 / (theta ** exps)
    yarn = cfg is not None and cfg.rope_scaling_type == "yarn"
    if yarn:
        factor = cfg.rope_scaling_factor
        orig = cfg.rope_scaling_original_max_position_embeddings

        def corr_dim(n_rot):
            # the dim whose wavelength completes n_rot rotations at orig
            return head_dim * math.log(orig / (n_rot * 2 * math.pi)) / (2 * math.log(theta))

        lo, hi = corr_dim(cfg.rope_scaling_beta_fast), corr_dim(cfg.rope_scaling_beta_slow)
        if cfg.rope_scaling_truncate:
            lo, hi = math.floor(lo), math.ceil(hi)
        low, high = max(lo, 0), min(hi, head_dim - 1)
        if low == high:
            high += 0.001  # the singularity guard of transformers
        dims = torch.arange(head_dim // 2, dtype=torch.float32, device=device)
        extrap = 1.0 - torch.clamp((dims - low) / (high - low), 0.0, 1.0)
        inv_freq = (inv_freq / factor) * (1.0 - extrap) + inv_freq * extrap
    t = torch.arange(max_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)
    cos, sin = torch.cos(freqs), torch.sin(freqs)
    if yarn:
        f = yarn_attention_factor(cfg)
        cos, sin = cos * f, sin * f
    return cos, sin


def yarn_mscale(scale: float, mscale: float = 1.0) -> float:
    """YaRN's attention-magnitude correction: 0.1 mscale ln(scale) + 1."""
    if scale <= 1.0:
        return 1.0
    return 0.1 * mscale * math.log(scale) + 1.0


def yarn_attention_factor(cfg: ModelConfig) -> float:
    """The multiplier on cos and sin under yarn scaling (the attention
    factor transformers infers)."""
    f, m, mad = (cfg.rope_scaling_factor, cfg.rope_scaling_mscale,
                 cfg.rope_scaling_mscale_all_dim)
    if m and mad:
        return yarn_mscale(f, m) / yarn_mscale(f, mad)
    return yarn_mscale(f)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, cos, sin) -> torch.Tensor:
    """x [B, T, H, D]; positions [B, T] absolute positions (half-split pairs)."""
    c = cos[positions][:, :, None, :]
    s = sin[positions][:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def alibi_slopes(n_heads: int) -> torch.Tensor:
    """ALiBi head slopes (Press et al. 2021, the BLOOM scheme) as [n_heads]
    f32: for 2^k heads the geometric sequence 2^(-8 (i + 1) / n); other
    counts take the closest lower power of two's sequence plus every other
    entry of the doubled one (the transformers ``build_alibi_tensor``
    recipe, as the JAX package's ``alibi_slopes``)."""
    def pow2(n):
        start = 2.0 ** (-(2.0 ** -(math.log2(n) - 3)))
        return [start ** (i + 1) for i in range(n)]

    if math.log2(n_heads).is_integer():
        slopes = pow2(n_heads)
    else:
        c = 2 ** math.floor(math.log2(n_heads))
        slopes = pow2(c) + pow2(2 * c)[0::2][:n_heads - c]
    return torch.tensor(slopes, dtype=torch.float32)


class RMSNorm(nn.Module):
    """``unit_offset`` (Gemma): the stored weight is zero-centred and the
    norm multiplies by ``weight + 1``, formed in f32 (a fresh norm stores 0)."""

    def __init__(self, dim: int, eps: float = 1e-5, dtype=torch.bfloat16, device=None,
                 unit_offset: bool = False):
        super().__init__()
        self.eps, self.dtype, self.unit_offset = eps, dtype, unit_offset
        init = torch.zeros if unit_offset else torch.ones
        self.weight = nn.Parameter(
            init(dim, dtype=torch.float32, device=resolve_device(device)),
            requires_grad=False)

    def effective_weight(self) -> torch.Tensor:
        return self.weight + 1.0 if self.unit_offset else self.weight

    def forward(self, x):
        return rms_norm(x, self.effective_weight(), self.eps, self.dtype)

    def quantized(self, x):
        """The norm fused with per-token int8 quantization: (xq, s_x), what
        ``ops.shared_rowquant(self(x))`` gives, in one pass."""
        return ops.rms_norm_quant(x, self.effective_weight(), eps=self.eps,
                                  cast_dtype=self.dtype)


class LayerNorm(nn.Module):
    """Mean-centred norm with a weight and a bias (BLOOM): f32 math, output
    in the activation dtype, as the JAX model's ``LayerNorm``."""

    def __init__(self, dim: int, eps: float = 1e-5, dtype=torch.bfloat16, device=None):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        device = resolve_device(device)
        self.weight = nn.Parameter(torch.ones(dim, dtype=torch.float32, device=device),
                                   requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(dim, dtype=torch.float32, device=device),
                                 requires_grad=False)

    def forward(self, x):
        xf = x.float()
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + self.eps)
        return (y * self.weight + self.bias).to(self.dtype)


def make_norm(cfg: ModelConfig, dtype, device=None) -> nn.Module:
    """The model-wide norm of ``cfg.norm_type``."""
    if cfg.norm_type == "layernorm":
        return LayerNorm(cfg.hidden_size, cfg.rms_norm_eps, dtype, device)
    return RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, dtype, device, cfg.rmsnorm_unit_offset)


# Modes whose projections read int8 activations: a block quantizes its
# input once for all the projections that read it.
ROWQUANT_MODES = ("dynamic", "dynamic_int4")


def producer_fused(mode: str) -> bool:
    """Whether a layer of ``mode`` makes its int8 activations in the
    producer: both norms through ``ops.rms_norm_quant`` and the gate through
    ``ops.swiglu_quant``. As in the JAX model, "dynamic" only (under
    ``FUSED_QUANT=on``); dynamic_int4 keeps its shared rowquant."""
    return mode == "dynamic" and ops.resolve_fused_quant()


def _tp(tp_group) -> int:
    return 1 if tp_group is None else tp_group.size


class Attention(nn.Module):
    """GQA attention of layer ``layer_idx``: its sliding window
    (``cfg.layer_window``), score scale (query_pre_attn_scalar^-0.5 when
    set), logit softcap, ALiBi slopes and learned sinks (``sinks`` [H] f32,
    under ``cfg.learned_attention_sinks``) go to the cache, or to
    ``mha_attention`` without one. Under ALiBi, q and k take no RoPE.

    ``tp_group`` (tensor parallelism, a ``parallel.mesh.RankGroup``): this
    rank's H/tp query and KV/tp key/value heads (column-parallel q/k/v) and
    a row-parallel o_proj reduced over the group (through the ring under
    ``collective``)."""

    def __init__(self, cfg: ModelConfig, mode: str, dtype, device=None, int4_group: int = 128,
                 layer_idx: int = 0, tp_group=None, collective: bool = False):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        tp = _tp(tp_group)
        self.H, self.KV = cfg.num_attention_heads // tp, cfg.num_key_value_heads // tp
        self.variants = {
            "window": cfg.layer_window(layer_idx),
            "scale": (cfg.query_pre_attn_scalar**-0.5 if cfg.query_pre_attn_scalar > 0.0
                      else 0.0),
            "softcap": cfg.attn_logit_softcap}
        device = resolve_device(device)
        D, H, KV, Dh = cfg.hidden_size, self.H, self.KV, cfg.head_dim
        lin = lambda k, n, bias, **kw: QLinear(k, n, mode, bias=bias, dtype=dtype,
                                               device=device, int4_group=int4_group, **kw)
        self.q_proj = lin(D, H * Dh, cfg.attention_bias)
        self.k_proj = lin(D, KV * Dh, cfg.attention_bias)
        self.v_proj = lin(D, KV * Dh, cfg.attention_bias)
        self.o_proj = lin(H * Dh, D, cfg.attention_out_bias, psum_axis=tp_group,
                          collective=collective)
        self.alibi = cfg.position_embedding == "alibi"
        if self.alibi:
            self.register_buffer("alibi_slopes", alibi_slopes(H).to(device), persistent=False)
        self.sinks = (nn.Parameter(torch.zeros(H, device=device), requires_grad=False)
                      if cfg.learned_attention_sinks else None)

    def forward(self, x, positions, cos, sin, cache=None, advance=None, preq=None):
        """``preq``: the (xq, s_x) of the normed input from the producer
        (``RMSNorm.quantized``); q/k/v then read it and ``x`` may be None."""
        H, KV, Dh = self.H, self.KV, self.cfg.head_dim
        if preq is None:
            B, T, _ = x.shape
            x = x.to(self.dtype)
            # q/k/v read the same activation: quantize it once for all three.
            preq = ops.shared_rowquant(x) if self.q_proj.mode in ROWQUANT_MODES else None
        else:
            B, T = preq[0].shape[:2]
        q = self.q_proj(x, preq).reshape(B, T, H, Dh)
        k = self.k_proj(x, preq).reshape(B, T, KV, Dh)
        v = self.v_proj(x, preq).reshape(B, T, KV, Dh)
        slopes = self.alibi_slopes if self.alibi else None
        if not self.alibi:
            q = apply_rope(q, positions, cos, sin)
            k = apply_rope(k, positions, cos, sin)
        if cache is not None:
            out = cache.update_and_attend(q, k, v, advance, alibi_slopes=slopes,
                                          sink_logits=self.sinks, **self.variants)
        else:
            out = mha_attention(q, k, v, positions, positions, alibi_slopes=slopes,
                                sink_logits=self.sinks, **self.variants)
        return self.o_proj(out.reshape(B, T, H * Dh))


class MLP(nn.Module):
    """Gated (SwiGLU, GeGLU) or, with ``cfg.mlp_gated`` False, the plain
    up_proj -> act -> down_proj of BLOOM; biased with ``cfg.mlp_bias``."""

    def __init__(self, cfg: ModelConfig, mode: str, dtype, device=None, int4_group: int = 128,
                 tp_group=None, collective: bool = False):
        super().__init__()
        self.dtype = dtype
        # silu, or the tanh approximation of gelu ("gelu_tanh", "gelu")
        self.act = "silu" if cfg.hidden_act == "silu" else "gelu"
        self.gated = cfg.mlp_gated
        device = resolve_device(device)
        # column-parallel gate/up over I/tp, row-parallel down_proj
        D, I = cfg.hidden_size, cfg.intermediate_size // _tp(tp_group)
        lin = lambda k, n, **kw: QLinear(k, n, mode, bias=cfg.mlp_bias, dtype=dtype,
                                         device=device, int4_group=int4_group, **kw)
        if self.gated:
            self.gate_proj = lin(D, I)
        self.up_proj = lin(D, I)
        self.down_proj = lin(I, D, psum_axis=tp_group, collective=collective)
        # the ring quantizes down_proj's input itself (the JAX gating)
        self.ring = tp_group is not None and collective

    def forward(self, x, preq=None):
        """``preq``: as in ``Attention.forward``, for gate/up. Under
        ``producer_fused``, the gate and its quantization are one kernel
        (``ops.swiglu_quant``) and ``down_proj`` reads its (hq, s_h)."""
        if preq is None:
            x = x.to(self.dtype)
            preq = ops.shared_rowquant(x) if self.up_proj.mode in ROWQUANT_MODES else None
        if not self.gated:
            h = activation(self.act)(self.up_proj(x, preq).float()).to(self.dtype)
            return self.down_proj(h)
        gate = self.gate_proj(x, preq)
        up = self.up_proj(x, preq)
        # the linears' mode, not the constructor's: quantize_model converts
        # them in place
        if producer_fused(self.gate_proj.mode) and not self.ring:
            return self.down_proj(None, ops.swiglu_quant(gate, up, act=self.act,
                                                         cast_dtype=self.dtype))
        return self.down_proj(swiglu(gate, up, self.act, self.dtype))


class DecoderLayer(nn.Module):
    """Pre-norm block; with ``cfg.sandwich_norms`` (Gemma-2),
    ``post_attention_layernorm`` norms the attention OUTPUT, and
    ``pre_feedforward_layernorm`` / ``post_feedforward_layernorm`` the MLP's
    input and output. Under ``cfg.layer_is_moe(layer_idx)`` the MLP is a
    ``MoEMLP`` (``block_sparse_moe``)."""

    def __init__(self, cfg: ModelConfig, mode: str, dtype, device=None, int4_group: int = 128,
                 layer_idx: int = 0, tp_group=None, collective: bool = False):
        super().__init__()
        device = resolve_device(device)
        norm = lambda: make_norm(cfg, dtype, device)
        self.sandwich = cfg.sandwich_norms
        self.rms = cfg.norm_type == "rmsnorm"
        self.input_layernorm = norm()
        self.self_attn = Attention(cfg, mode, dtype, device, int4_group, layer_idx, tp_group,
                                   collective)
        self.post_attention_layernorm = norm()
        if self.sandwich:
            self.pre_feedforward_layernorm = norm()
            self.post_feedforward_layernorm = norm()
        self.moe = cfg.layer_is_moe(layer_idx)
        # a MoE model fuses no post-attention norm, on its dense layers too
        self.fuse_mlp_norm = not cfg.is_moe
        if self.moe:
            self.block_sparse_moe = MoEMLP(cfg, mode, dtype, device, int4_group)
        else:
            self.mlp = MLP(cfg, mode, dtype, device, int4_group, tp_group, collective)

    def _mlp(self, x, preq=None):
        return self.block_sparse_moe(x) if self.moe else self.mlp(x, preq)

    def forward(self, x, positions, cos, sin, cache=None, advance=None):
        if self.sandwich:
            h = self.self_attn(self.input_layernorm(x), positions, cos, sin, cache, advance)
            x = x + self.post_attention_layernorm(h)
            h = self._mlp(self.pre_feedforward_layernorm(x))
            return x + self.post_feedforward_layernorm(h)
        # the linears' mode, not the constructor's: quantize_model converts
        # them in place
        fused = self.rms and producer_fused(self.self_attn.q_proj.mode)
        if fused:
            # the norm emits the projections' int8 input directly; the normed
            # activation itself is never made
            x = x + self.self_attn(None, positions, cos, sin, cache, advance,
                                   preq=self.input_layernorm.quantized(x))
        else:
            x = x + self.self_attn(self.input_layernorm(x), positions, cos, sin,
                                   cache, advance)
        if fused and self.fuse_mlp_norm:
            return x + self.mlp(None, preq=self.post_attention_layernorm.quantized(x))
        return x + self._mlp(self.post_attention_layernorm(x))


def _check_tp(cfg: ModelConfig, mode: str, tp: int) -> None:
    """Raise on what tensor parallelism does not take in this slice."""
    if mode not in ("fp", "dynamic"):
        raise NotImplementedError(f"mode {mode!r} under tensor parallelism is not ported yet "
                                  "(fp and dynamic are)")
    for what, on in (("MoE (expert parallelism)", cfg.is_moe),
                     ("learned attention sinks", cfg.learned_attention_sinks),
                     ("ALiBi", cfg.position_embedding == "alibi")):
        if on:
            raise NotImplementedError(f"{what} under tensor parallelism is not ported yet")
    for name, n in (("num_attention_heads", cfg.num_attention_heads),
                    ("num_key_value_heads", cfg.num_key_value_heads),
                    ("intermediate_size", cfg.intermediate_size),
                    ("vocab_size", cfg.vocab_size)):
        if n % tp:
            raise ValueError(f"{name}={n} does not split over tp={tp}")


class LlamaModel(nn.Module):
    """Decoder-only LM.

    ``model(tokens)`` scores without a cache; ``model(tokens, positions,
    caches, advance)`` runs incrementally and updates ``caches`` in place.
    Both return f32 logits [B, T, V]. The model lives on ``device``: CUDA
    unless the caller names another (a CUDA request without a card raises).
    ``int4_group``: the group of the int4 modes' weights, every projection
    and ``lm_head`` (``pick_int4_group(K, int4_group)`` per projection).

    ``tp_group``: one rank of a tensor-parallel model (``parallel.tp_model``
    builds them), run inside ``Mesh.run``: H/tp and KV/tp heads, I/tp MLP
    columns, a vocab-parallel lm_head whose logits are all-gathered, the
    embedding and norms replicated; ``collective`` sends o_proj's and
    down_proj's reductions through the ring (``parallel.collective``).
    Modes fp and dynamic only; MoE, learned sinks and ALiBi raise.
    """

    def __init__(self, cfg: ModelConfig, mode: str = "dynamic",
                 dtype=torch.bfloat16, device=None, int4_group: int = 128,
                 tp_group=None, collective: bool = False):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        self.device = resolve_device(device)
        self.tp_group = tp_group
        if tp_group is not None:
            _check_tp(cfg, mode, tp_group.size)
        dev = self.device
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                         dtype=dtype, device=dev)
        self.embed_tokens.weight.requires_grad_(False)
        # Gemma's normalizer sqrt(D), rounded to the activation dtype as in
        # the JAX model and HF (bf16: 59.75 at D = 3584)
        self.embed_scale = (float(torch.tensor(cfg.hidden_size**0.5, dtype=dtype))
                            if cfg.scale_embeddings else None)
        if cfg.embedding_layernorm:
            self.embed_norm = make_norm(cfg, dtype, dev)
        for i in range(cfg.num_hidden_layers):
            self.add_module(f"layers_{i}", DecoderLayer(cfg, mode, dtype, dev, int4_group, i,
                                                        tp_group, collective))
        self.norm = make_norm(cfg, dtype, dev)
        self.lm_head = QLinear(cfg.hidden_size, cfg.vocab_size // _tp(tp_group), mode,
                               bias=False, dtype=dtype, device=dev, int4_group=int4_group)
        cos, sin = rope_tables(cfg.head_dim, cfg.max_position_embeddings,
                               cfg.rope_theta, cfg, dev)
        self.register_buffer("rope_cos", cos, persistent=False)
        self.register_buffer("rope_sin", sin, persistent=False)

    @property
    def layers(self) -> list:
        return [getattr(self, f"layers_{i}") for i in range(self.cfg.num_hidden_layers)]

    @torch.no_grad()
    def init_random_(self, seed: int = 0) -> "LlamaModel":
        """Random weights from ``seed``, made on the model's device one
        projection at a time: in the quantized modes (int8 or int4) each fp
        weight is quantized as soon as it is drawn, so no fp copy of the
        model exists whole. Linear weights are
        N(0, 1/K), embeddings N(0, 1) as the first layer sees them (N(0, 1/D)
        under Gemma's sqrt(D) normalizer), norms the identity (weights 1, or 0
        when stored zero-centred; biases 0), linear biases 0. A MoE router
        is drawn N(0, 1/D) in f32, each expert's weight N(0, 1/K) and
        quantized alone (so the peak stays near the quantized model); expert
        biases and learned sinks are 0, as the JAX package initializes
        them."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        emb = torch.randn(self.embed_tokens.weight.shape, generator=gen, device=self.device)
        if self.cfg.scale_embeddings:
            emb.mul_(self.cfg.hidden_size**-0.5)
        self.embed_tokens.weight.copy_(emb)
        del emb
        for module in self.modules():
            if isinstance(module, QLinear):
                w = torch.randn(module.out_features, module.in_features,
                                generator=gen, device=self.device)
                module.set_weight(w.mul_(1.0 / math.sqrt(module.in_features)))
                del w
                if module.bias is not None:
                    module.bias.zero_()
            elif isinstance(module, RMSNorm):
                module.weight.fill_(0.0 if module.unit_offset else 1.0)
            elif isinstance(module, LayerNorm):
                module.weight.fill_(1.0)
                module.bias.zero_()
            elif isinstance(module, StackedWeight):
                for e in range(module.E):
                    w = torch.randn(module.N, module.K, generator=gen, device=self.device)
                    module.set_expert(e, w.mul_(1.0 / math.sqrt(module.K)))
                    del w
            elif isinstance(module, MoEMLP):
                D = module.gate.in_features
                module.gate.weight.copy_(torch.randn(module.gate.weight.shape, generator=gen,
                                                     device=self.device).mul_(D**-0.5))
                for p in (module.gate.bias, getattr(module, "gate_up_proj_bias", None),
                          getattr(module, "down_proj_bias", None)):
                    if p is not None:
                        p.zero_()
            elif isinstance(module, Attention) and module.sinks is not None:
                module.sinks.zero_()
        return self

    @torch.no_grad()
    def forward(self, tokens, positions=None, caches=None, advance=None):
        B, T = tokens.shape
        if positions is None:
            positions = torch.arange(T, device=tokens.device)[None, :].expand(B, T)
        positions = positions.long()
        x = self.embed_tokens(tokens.long())
        if self.embed_scale is not None:
            x = x * self.embed_scale
        if self.cfg.embedding_layernorm:
            x = self.embed_norm(x)
        for i, layer in enumerate(self.layers):
            cache = caches[i] if caches is not None else None
            x = layer(x, positions, self.rope_cos, self.rope_sin, cache, advance)
        x = self.norm(x)
        logits = self.lm_head(x).float()
        if self.tp_group is not None:  # vocab-parallel: every rank gets all of V
            logits = self.tp_group.all_gather(logits, axis=logits.ndim - 1, tiled=True)
        cap = self.cfg.final_logit_softcap
        return cap * torch.tanh(logits / cap) if cap else logits
