"""The port's mixture of experts against the JAX package's
(``protoquant_tpu/models/moe.py``): ``expert_capacity`` and
``dispatch_combine`` bit for bit, with capacity overflow, and ``MoEMLP`` of
both variants ("mixtral", "gpt_oss") in the four modes the port has, on
params carried across by ``params_from_numpy``.

Both run in float32 on the CPU (and one bf16 case). ``weight_only_int4``
experts run the JAX package's wo4 split kernel in interpret mode, as its
own tests run it. Outputs agree within MOE_ATOL: the two frameworks sum the
same products in different orders (the router's logits, the experts'
f32 sums, the combine), which reaches the outputs at the 1e-6 level;
routing and every int8 activation code are the same on these seeded
inputs. At capacity factor 1.25 an expert's queue overflows, so the
dropped assignments must be the same ones too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from protoquant_tpu.core.qtensor import QTensor as JQTensor
from protoquant_tpu.models.moe import MoEMLP as JMoEMLP
from protoquant_tpu.models.moe import dispatch_combine as j_dispatch_combine
from protoquant_tpu.models.moe import expert_capacity as j_expert_capacity
from protoquant_tpu.utils.config import ModelConfig as JModelConfig
from protoquant_tpu_torch import ModelConfig, QTensor, QTensor4, params_from_numpy
from protoquant_tpu_torch.models.moe import MoEMLP, dispatch_combine, expert_capacity
from test_torch_int4 import to_numpy_tree

MOE_ATOL = 2e-5  # float32; outputs of magnitude ~1-10
BF16_ATOL = 3e-2  # bfloat16 activations: an ulp of the output (magnitude ~4)

BASE = dict(vocab_size=64, hidden_size=64, intermediate_size=32, num_hidden_layers=1,
            num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64,
            num_local_experts=4, num_experts_per_tok=2)
VARIANTS = {
    "mixtral": dict(moe_norm_topk=True, routed_scaling_factor=1.5),
    "gpt_oss": dict(moe_variant="gpt_oss", moe_router_bias=True, moe_softmax_after_topk=True),
}
MODES = ("fp", "dynamic", "weight_only", "weight_only_int4")


@pytest.mark.parametrize("factor", [0.5, 1.25, 8.0])
@pytest.mark.parametrize("n_tokens", [1, 4, 7, 512])
def test_expert_capacity_matches_jax(n_tokens, factor):
    kw = dict(BASE, expert_capacity_factor=factor, num_local_experts=32,
              num_experts_per_tok=4)
    assert expert_capacity(n_tokens, ModelConfig(**kw)) == j_expert_capacity(
        n_tokens, JModelConfig(**kw))


@pytest.mark.parametrize("capacity", [1, 3, 16])
def test_dispatch_combine_bitwise(capacity):
    """Random top-3 choices of 13 tokens over 5 experts: at capacity 1 and 3
    queues overflow (choice-major priority decides who is dropped)."""
    rng = np.random.default_rng(capacity)
    idx = np.stack([rng.permutation(5)[:3] for _ in range(13)]).astype(np.int32)
    vals = rng.random((13, 3)).astype(np.float32)
    want = j_dispatch_combine(jnp.asarray(idx), jnp.asarray(vals), 5, capacity)
    got = dispatch_combine(torch.from_numpy(idx), torch.from_numpy(vals), 5, capacity)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (float(got[0].sum()) < 39) == (capacity < 13)  # 39 assignments


def test_dispatch_overflow_drops_to_zero():
    """Every token picks expert 0 at capacity 1: only the first is kept."""
    dispatch, combine = dispatch_combine(torch.zeros(6, 1, dtype=torch.long),
                                         torch.ones(6, 1), 2, 1)
    assert dispatch.sum() == 1 and dispatch[0, 0, 0] == 1 and combine[1:].sum() == 0


def test_stacked_qtensors_match_jax():
    """A 3-D QTensor and QTensor4 of [E, N, K] equal the JAX package's of
    [E, K, N], transposed per expert."""
    w = np.random.default_rng(0).standard_normal((3, 64, 48)).astype(np.float32)  # [E, K, N]
    wt = torch.from_numpy(np.swapaxes(w, 1, 2).copy())
    jq, q = JQTensor.quantize(jnp.asarray(w), axis=1), QTensor.quantize(wt, axis=2)
    np.testing.assert_array_equal(q.data.numpy(), np.swapaxes(np.asarray(jq.data), 1, 2))
    np.testing.assert_array_equal(q.scale.numpy(), np.asarray(jq.scale))
    from protoquant_tpu.core.qtensor import QTensor4 as JQTensor4
    jq4, q4 = JQTensor4.quantize(jnp.asarray(w), group=32), QTensor4.quantize(wt, group=32)
    np.testing.assert_array_equal(q4.data.numpy(), np.swapaxes(np.asarray(jq4.data), 1, 2))
    np.testing.assert_array_equal(q4.scale.numpy(), np.swapaxes(np.asarray(jq4.scale), 1, 2))
    assert q4.shape == (3, 48, 64)
    for e in range(3):  # the JAX QTensor4 dequantizes one 2-D expert at a time
        one = JQTensor4(jq4.data[e], jq4.scale[e], 32, 64)
        np.testing.assert_array_equal(q4.dequantize()[e].numpy(), np.asarray(one.dequantize()).T)


def _randomize_biases(tree, rng):
    """Router and expert biases N(0, 0.5): load-bearing (flax inits 0)."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items") and not isinstance(v, JQTensor):
            out[k] = _randomize_biases(v, rng)
        elif k in ("bias", "gate_up_proj_bias", "down_proj_bias"):
            out[k] = jnp.asarray(rng.normal(0, 0.5, np.shape(v)).astype(np.float32))
        else:
            out[k] = v
    return out


def _pair(variant, mode, factor, dtype=torch.float32):
    kw = dict(BASE, expert_capacity_factor=factor, **VARIANTS[variant])
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jm = JMoEMLP(JModelConfig(**kw), mode=mode, dtype=jdt, int4_group=32)
    x = np.random.default_rng(3).standard_normal((2, 9, 64)).astype(np.float32) * 3
    params = jm.init(jax.random.PRNGKey(5), jnp.asarray(x, jdt))
    params = _randomize_biases(params, np.random.default_rng(5))
    tm = MoEMLP(ModelConfig(**kw), mode, dtype, device="cpu", int4_group=32)
    tm.load_state_dict(params_from_numpy(to_numpy_tree(params)), strict=True)
    return jm, params, tm, x


@pytest.mark.parametrize("factor", [1.25, 8.0])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("variant", VARIANTS)
def test_moe_mlp_matches_jax(variant, mode, factor):
    """18 tokens of width 64 over 4 experts (top 2): at factor 1.25 each
    expert holds 12 of the 36 assignments, and queues overflow."""
    jm, params, tm, x = _pair(variant, mode, factor)
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    got = tm(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, atol=MOE_ATOL, rtol=0)
    dropped = tm.assignments - float(tm.kept)
    assert (dropped > 0) == (factor == 1.25), dropped
    if variant == "gpt_oss" and mode == "fp":  # the clamps bite: gate and up pass 7
        gu = torch.from_numpy(x).reshape(-1, 64) @ tm.gate_up_proj.weight[0].t()
        assert (gu[:, 0::2] > 7).any() and (gu[:, 1::2].abs() > 7).any()


def test_moe_mlp_bf16_dynamic_matches_jax():
    jm, params, tm, x = _pair("gpt_oss", "dynamic", 1.25, torch.bfloat16)
    want = np.asarray(jm.apply(params, jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    got = tm(torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=BF16_ATOL, rtol=0)


def test_gate_up_interleave_is_load_bearing():
    """gate = even columns, up = odd: a gate_up weight laid out in halves
    instead changes the output (the planted fault of the chip run's
    agreement reads the halves of the right weight)."""
    jm, params, tm, x = _pair("gpt_oss", "fp", 8.0)
    want = tm(torch.from_numpy(x))
    with torch.no_grad():
        w = tm.gate_up_proj.weight.clone()
        tm.gate_up_proj.weight.copy_(torch.cat([w[:, 0::2], w[:, 1::2]], dim=1))
    assert (tm(torch.from_numpy(x)) - want).abs().max() > 0.1


def test_moe_refuses_unported_modes_and_routing():
    with pytest.raises(ValueError, match="MoE mode"):
        MoEMLP(ModelConfig(**BASE), "dynamic_int4", torch.float32, device="cpu")
    for bad in (dict(moe_score_func="sigmoid"), dict(moe_gate_bias=True),
                dict(n_group=4, topk_group=2), dict(n_shared_experts=1)):
        with pytest.raises(ValueError, match="DeepSeek"):
            ModelConfig(**BASE, **bad)
    with pytest.raises(ValueError, match="moe_variant"):
        ModelConfig(**BASE, moe_variant="deepseek")
