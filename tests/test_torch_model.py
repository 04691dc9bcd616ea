"""The port's Llama model against the JAX package's, weights carried across
by ``params_from_numpy``.

Both run in float32 on the CPU with the same int8 weights. Logits are held
to LOGIT_ATOL: RoPE, RMSNorm and SiLU round differently by an ulp in the two
frameworks, which reaches the logits (magnitude ~1) at the 1e-6 level.
Rarely an activation code moves by one step instead (an ulp on the boundary
of a rounding, or XLA's jitted quantizer multiplying by 1/127 where the
contract divides), and at hidden width 64 one such step can move a logit by
up to ~0.1; the seeded inputs below hit none, and the tolerance would catch
one. Greedy tokens must be identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from protoquant_tpu.core.qtensor import QTensor as JQTensor
from protoquant_tpu.models import LlamaModel as JLlamaModel
from protoquant_tpu.models import greedy_generate as j_greedy
from protoquant_tpu.models.llama import init_cache as j_init_cache
from protoquant_tpu.utils.config import ModelConfig as JModelConfig
from protoquant_tpu_torch import LlamaModel, ModelConfig, greedy_generate
from protoquant_tpu_torch.models import init_cache, params_from_numpy
from protoquant_tpu_torch.nn import QLinear, quantize_model

LOGIT_ATOL = 1e-3
DIMS = dict(vocab_size=64, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            max_position_embeddings=128)


def to_numpy_tree(tree):
    """flax params -> nested dicts of numpy arrays, a QTensor as {data, scale}."""
    if isinstance(tree, JQTensor):
        return {"data": np.asarray(tree.data), "scale": np.asarray(tree.scale)}
    if isinstance(tree, dict) or hasattr(tree, "items"):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


@pytest.fixture(scope="module")
def pair():
    jm = JLlamaModel(JModelConfig(**DIMS), mode="dynamic", dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))
    tm = LlamaModel(ModelConfig(**DIMS), mode="dynamic", dtype=torch.float32,
                    device="cpu")
    tm.load_state_dict(params_from_numpy(to_numpy_tree(params)), strict=True)
    return jm, params, tm


def _prompt(b, t, seed=0):
    return np.random.default_rng(seed).integers(1, DIMS["vocab_size"], (b, t)).astype(np.int32)


def test_params_from_numpy_transposes_kn_to_nk(pair):
    _, params, tm = pair
    p = params["params"]
    for path in (("layers_0", "self_attn", "q_proj"), ("layers_1", "mlp", "up_proj"),
                 ("layers_1", "mlp", "down_proj"), ("lm_head",)):
        node = p
        for key in path:
            node = node[key]
        qk = node["qkernel"]
        k, n = qk.data.shape
        lin = tm.get_submodule(".".join(path))
        assert tuple(lin.qweight.shape) == (n, k)
        assert lin.qweight.is_contiguous()
        np.testing.assert_array_equal(lin.qweight.numpy(), np.asarray(qk.data).T)
        np.testing.assert_array_equal(lin.qscale.numpy(), np.asarray(qk.scale))
    np.testing.assert_array_equal(tm.embed_tokens.weight.numpy(),
                                  np.asarray(p["embed_tokens"]["embedding"]))


def test_fp_kernel_transposes_and_quantize_model_matches_jax():
    jm = JLlamaModel(JModelConfig(**DIMS), mode="fp", dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(1), jnp.zeros((1, 4), jnp.int32))
    tm = LlamaModel(ModelConfig(**DIMS), mode="fp", dtype=torch.float32, device="cpu")
    tm.load_state_dict(params_from_numpy(to_numpy_tree(params)), strict=True)
    w = np.asarray(params["params"]["layers_0"]["mlp"]["gate_proj"]["kernel"])
    np.testing.assert_array_equal(tm.layers_0.mlp.gate_proj.weight.numpy(), w.T)
    tokens = _prompt(2, 7, seed=1)
    want = np.asarray(jm.apply(params, jnp.asarray(tokens)))
    got = tm(torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, want, atol=LOGIT_ATOL, rtol=0)

    from protoquant_tpu.nn.convert import quantize_params

    quantize_model(tm)
    assert all(m.mode == "dynamic" for m in tm.modules() if isinstance(m, QLinear))
    jq = JLlamaModel(JModelConfig(**DIMS), mode="dynamic", dtype=jnp.float32)
    qparams = quantize_params(params)
    want = np.asarray(jq.apply(qparams, jnp.asarray(tokens)))
    np.testing.assert_allclose(tm(torch.from_numpy(tokens)).numpy(), want,
                               atol=LOGIT_ATOL, rtol=0)


def test_scoring_logits_close(pair):
    jm, params, tm = pair
    tokens = _prompt(2, 12)
    want = np.asarray(jm.apply(params, jnp.asarray(tokens)))
    got = tm(torch.from_numpy(tokens)).numpy()
    assert got.shape == want.shape == (2, 12, DIMS["vocab_size"])
    np.testing.assert_allclose(got, want, atol=LOGIT_ATOL, rtol=0)


def test_int8_cache_prefill_logits_close(pair):
    jm, params, tm = pair
    tokens = _prompt(2, 10, seed=2)
    cfg = jm.cfg
    jc = j_init_cache(cfg, 2, 32, kv_dtype=jnp.int8)
    pos = np.broadcast_to(np.arange(10)[None], (2, 10)).astype(np.int32)
    want, _ = jm.apply(params, jnp.asarray(tokens), jnp.asarray(pos), jc)
    tc = init_cache(tm.cfg, 2, 32, "cpu", kv_dtype="int8")
    got = tm(torch.from_numpy(tokens), torch.from_numpy(pos), tc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_ATOL, rtol=0)
    assert tc[0].lengths.tolist() == [10, 10]


def test_greedy_tokens_identical_16_steps(pair):
    jm, params, tm = pair
    prompt = _prompt(2, 6, seed=3)
    want = np.asarray(j_greedy(jm, params, jnp.asarray(prompt), 16, 32,
                               kv_dtype=jnp.int8))
    got = greedy_generate(tm, torch.from_numpy(prompt), 16, 32, kv_dtype="int8")
    np.testing.assert_array_equal(got.numpy(), want)

