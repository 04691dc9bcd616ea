"""The port's GPT-OSS path against the JAX package's: the ``gpt_oss_20b``
preset, the yarn RoPE tables, learned attention sinks in the int8, K4V8
and Int4 attentions' plain versions and in ``mha_attention``, and a tiny
GPT-OSS (learned sinks, yarn, biased q/k/v/o, an alternating window, the
gpt_oss MoE) through scoring, the bf16, int8, K4V8 and Int4 caches, greedy
decoding and the engine; paged, ring and K8V4 refuse learned sinks, as the
reference's caches do.

Attention: the plain versions against the Pallas kernels in interpret mode
(and ``int8_kv_attention_xla``) within ATOL, the KIVI ones within TOL, as in
``test_torch_ops.py`` and ``test_torch_kivi_kv.py``, with sinks drawn N(0,
2) so that some rows give them most of their mass. Models: float32 on the
CPU, weights carried by ``params_from_numpy``, biases and sinks drawn at
random so that they are load-bearing; logits within LOGIT_ATOL
(``test_torch_model.py``), greedy and engine tokens identical. The engines
run at expert capacity factor 8.0 (no assignment dropped) and 1.25, where a
decode step of 4 slots (idle ones included) gives each of 8 experts 2
places and drops assignments, so both engines must batch alike. KIVI runs
set INT4_KV_GROUP to 16 in both packages and drive the JAX model eagerly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import protoquant_tpu.models.kv_cache as jkv
from protoquant_tpu.engine import Engine as JEngine
from protoquant_tpu.engine import EngineConfig as JEngineConfig
from protoquant_tpu.engine.paged_kv import PagedInt8KVCache as JPagedKVCache
from protoquant_tpu.models import LlamaModel as JLlamaModel
from protoquant_tpu.models.llama import init_cache as j_init_cache
from protoquant_tpu.models.llama import mha_attention as j_mha_attention
from protoquant_tpu.models.llama import rope_tables as j_rope_tables
from protoquant_tpu.ops.attention import int4_kv_attention as j_int4_attention
from protoquant_tpu.ops.attention import int8_kv_attention as j_attention
from protoquant_tpu.ops.attention import int8_kv_attention_xla as j_attention_xla
from protoquant_tpu.ops.attention import k4v8_attention as j_k4v8_attention
from protoquant_tpu.utils.config import ModelConfig as JModelConfig
from protoquant_tpu_torch import (Engine, EngineConfig, LlamaModel, ModelConfig,
                                  greedy_generate, ops, params_from_numpy)
from protoquant_tpu_torch.engine.paged_kv import PagedInt8KVCache
from protoquant_tpu_torch.models import (MixedKVCache, RingInt8KVCache, cache_from_numpy,
                                         init_cache)
from protoquant_tpu_torch.models import kv_cache as tkv
from protoquant_tpu_torch.models.kv_cache import mha_attention
from protoquant_tpu_torch.models.llama import rope_tables
from test_torch_int4 import to_numpy_tree
from test_torch_model import LOGIT_ATOL

ATOL = 2e-5  # int8 attention, f32 on both sides (test_torch_ops.py)
TOL = 3e-5  # KIVI attention (test_torch_kivi_kv.py)
YARN_ATOL = 300 * 2.0**-24 * 1.4  # positions < 300, inv_freq <= 1

OSS_DIMS = dict(
    vocab_size=86, hidden_size=64, intermediate_size=32, num_hidden_layers=2,
    num_attention_heads=8, num_key_value_heads=2, max_position_embeddings=128,
    head_dim_override=16, sliding_window=8, alternating_sliding_window=True,
    attention_bias=True, attention_out_bias=True, learned_attention_sinks=True,
    num_local_experts=8, num_experts_per_tok=2, moe_variant="gpt_oss", moe_router_bias=True,
    moe_softmax_after_topk=True, rope_scaling_type="yarn", rope_scaling_factor=32.0,
    rope_scaling_beta_fast=32.0, rope_scaling_beta_slow=1.0, rope_scaling_truncate=False,
    rope_scaling_original_max_position_embeddings=16,
)
JAX_KV = {"bf16": jnp.bfloat16, "int8": jnp.int8, "k4v8": "k4v8", "int4": jnp.int4}


def test_gpt_oss_preset_matches_jax():
    port, ref = ModelConfig.gpt_oss_20b(), JModelConfig.gpt_oss_20b()
    for f in dataclasses.fields(port):
        assert getattr(port, f.name) == getattr(ref, f.name), f.name
    assert port.is_moe and all(port.layer_is_moe(i) for i in range(24))
    assert not ModelConfig(first_k_dense_replace=1, num_local_experts=4).layer_is_moe(0)


@pytest.mark.parametrize("kind", ["linear", "llama3", "longrope"])
def test_unported_rope_scalings_raise(kind):
    with pytest.raises(ValueError, match="rope_scaling_type"):
        ModelConfig(rope_scaling_type=kind)


@pytest.mark.parametrize("extra", [
    {},  # GPT-OSS: untruncated, no mscale
    {"rope_scaling_truncate": True},
    {"rope_scaling_mscale": 1.0, "rope_scaling_mscale_all_dim": 1.0},
    {"rope_scaling_mscale": 0.707, "rope_scaling_mscale_all_dim": 1.0,
     "rope_scaling_factor": 40.0, "rope_scaling_original_max_position_embeddings": 64},
])
def test_yarn_tables_match_jax(extra):
    kw = dict(rope_scaling_type="yarn", rope_scaling_factor=32.0, rope_scaling_truncate=False,
              rope_scaling_original_max_position_embeddings=4096)
    kw.update(extra)
    for hd, theta in ((64, 150000.0), (16, 10000.0)):
        cos, sin = rope_tables(hd, 300, theta, ModelConfig(**kw))
        jcos, jsin = j_rope_tables(hd, 300, theta, JModelConfig(**kw))
        # pow rounds an inverse frequency an ulp apart in the two frameworks
        # (as for plain RoPE): the angle at position p then differs by up to
        # p * 2^-24 * inv_freq, times the attention factor (< 1.4)
        np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=YARN_ATOL, rtol=0)
        np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), atol=YARN_ATOL, rtol=0)
        plain, _ = rope_tables(hd, 300, theta)
        assert (cos - plain).abs().max() > 0.1  # the scaling is load-bearing


# -- learned sinks in the attentions ------------------------------------------------

B, KV, H, DH, S = 3, 2, 4, 16, 64


def _sinks(seed):
    return np.random.default_rng(seed).normal(0, 2, H).astype(np.float32)


@pytest.mark.parametrize("window", [0, 8])
@pytest.mark.parametrize("t_q", [1, 4])
def test_int8_sinks_vs_pallas(t_q, window):
    rng = np.random.default_rng(30 + t_q + window)
    q = rng.standard_normal((B, t_q, H, DH)).astype(np.float32)
    kq = rng.integers(-127, 128, (B, KV, S, DH)).astype(np.int8)
    vq = rng.integers(-127, 128, (B, KV, S, DH)).astype(np.int8)
    ks = (rng.random((B, KV, S)) * 0.02 + 0.001).astype(np.float32)
    vs = (rng.random((B, KV, S)) * 0.02 + 0.001).astype(np.float32)
    lengths = np.array([0, 21, S - t_q], np.int32)  # ragged, one full row
    sl = _sinks(t_q + window)
    args = [q, kq, ks, vq, vs, lengths]
    kw = dict(window=window, sink_logits=jnp.asarray(sl))
    j_kernel = np.asarray(j_attention(*map(jnp.asarray, args), interpret=True, **kw))
    j_xla = np.asarray(j_attention_xla(*map(jnp.asarray, args), **kw))
    targs = list(map(torch.from_numpy, args))
    got = ops.int8_kv_attention(*targs, window=window, sink_logits=torch.from_numpy(sl))
    np.testing.assert_allclose(got.numpy(), j_xla, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), j_kernel, atol=ATOL, rtol=0)
    assert (got - ops.int8_kv_attention(*targs, window=window)).abs().max() > 1e-2


def test_int8_sinks_compose_with_ring_positions():
    """Learned sinks with scattered positions and StreamingLLM sinks, as
    ``int8_kv_attention_xla`` computes them (no JAX cache passes both)."""
    rng = np.random.default_rng(7)
    q = rng.standard_normal((1, 1, H, DH)).astype(np.float32)
    kq = rng.integers(-127, 128, (1, KV, 32, DH)).astype(np.int8)
    ks = np.full((1, KV, 32), 0.01, np.float32)
    pos = rng.permutation(40)[:32].astype(np.int32)[None]
    lengths = np.array([39], np.int32)
    sl = _sinks(1)
    want = j_attention_xla(*map(jnp.asarray, (q, kq, ks, kq, ks, lengths)), window=6,
                           k_positions=jnp.asarray(pos), sinks=2, sink_logits=jnp.asarray(sl))
    got = ops.int8_kv_attention(*map(torch.from_numpy, (q, kq, ks, kq, ks, lengths)),
                                window=6, k_positions=torch.from_numpy(pos), sinks=2,
                                sink_logits=torch.from_numpy(sl))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


KG, KS = 16, 128
KIVI_FIELDS = ("kq", "kchs", "vq", "vs", "ktail", "kts", "vtail", "vts")
KIVI = {"k4v8": (jkv.K4V8KVCache, tkv.K4V8KVCache, j_k4v8_attention, "k4v8_attention"),
        "int4": (jkv.Int4KVCache, tkv.Int4KVCache, j_int4_attention, "int4_kv_attention")}


@pytest.mark.parametrize("window", [0, 20])
@pytest.mark.parametrize("t_q", [1, 4])
@pytest.mark.parametrize("tier", KIVI)
def test_kivi_sinks_vs_pallas(tier, t_q, window):
    """Learned sinks over the packed store and the tail (lengths 100,
    frontier 96, and 30), against the JAX kernel in interpret mode."""
    jcls, tcls, j_attn, name = KIVI[tier]
    rng = np.random.default_rng(17 + t_q + window)
    before = np.array([100, 30], np.int32)
    rows = []
    for n in before:
        x = jnp.asarray(rng.standard_normal((1, n + t_q, KV, DH)).astype(np.float32) * 3)
        c = jcls.init(1, KS, KV, DH, group=KG).update(x[:, :n], x[:, :n])
        rows.append(c.update(x[:, n:], x[:, n:]))
    state = {f: np.concatenate([np.asarray(getattr(c, f)) for c in rows])
             for f in KIVI_FIELDS + ("lengths",)}
    q = rng.standard_normal((2, t_q, H, DH)).astype(np.float32) * 0.3
    sl = _sinks(t_q)
    want = np.asarray(j_attn(jnp.asarray(q), *(jnp.asarray(state[f]) for f in KIVI_FIELDS),
                             jnp.asarray(before), jnp.asarray(state["lengths"]), group=KG,
                             window=window, sink_logits=jnp.asarray(sl), interpret=True))
    tc = cache_from_numpy(tcls, state, group=KG, device="cpu")
    args = (torch.from_numpy(q), *(getattr(tc, f) for f in KIVI_FIELDS),
            torch.from_numpy(before), tc.lengths)
    got = getattr(ops, name)(*args, group=KG, window=window, sink_logits=torch.from_numpy(sl))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    assert (got - getattr(ops, name)(*args, group=KG, window=window)).abs().max() > 1e-2


@pytest.mark.parametrize("window", [0, 5])
def test_mha_attention_sinks_match_jax(window):
    rng = np.random.default_rng(window)
    q = rng.standard_normal((2, 6, H, DH)).astype(np.float32)
    k = rng.standard_normal((2, 6, KV, DH)).astype(np.float32)
    v = rng.standard_normal((2, 6, KV, DH)).astype(np.float32)
    pos = np.broadcast_to(np.arange(6)[None], (2, 6)).astype(np.int32)
    sl = _sinks(window)
    want = j_mha_attention(*map(jnp.asarray, (q, k, v, pos, pos)), window=window,
                           sink_logits=jnp.asarray(sl))
    got = mha_attention(*map(torch.from_numpy, (q, k, v, pos, pos)), window=window,
                        sink_logits=torch.from_numpy(sl))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


def test_caches_that_take_no_sinks_refuse_them():
    """Ring, K8V4 and paged refuse learned sinks before writing, as the JAX
    caches do (its ring and paged caches take no ``sink_logits``, its K8V4
    raises)."""
    kw = {"sink_logits": jnp.zeros(4)}
    jq, jk = jnp.zeros((1, 1, 4, 16)), jnp.ones((1, 1, 2, 16))
    with pytest.raises(TypeError):
        jkv.RingInt8KVCache.init(1, 8, 4, 2, 16).update_and_attend(jq, jk, jk, **kw)
    with pytest.raises(NotImplementedError):
        jkv.MixedKVCache.init(1, 16, 2, 16).update_and_attend(jq, jk, jk, **kw)
    with pytest.raises(TypeError):
        JPagedKVCache.init(1, 3, 2, 8, 2, 16).update_and_attend(jq, jk, jk, **kw)
    q, k = torch.zeros(1, 1, 4, 16), torch.ones(1, 1, 2, 16)
    for c in (RingInt8KVCache.init(1, 8, 4, 2, 16, device="cpu"),
              MixedKVCache.init(1, 16, 2, 16, device="cpu"),
              PagedInt8KVCache.init(1, 3, 2, 8, 2, 16, device="cpu")):
        with pytest.raises(NotImplementedError, match="GPT-OSS"):
            c.update_and_attend(q, k, k, sink_logits=torch.zeros(4))
        assert c.lengths.tolist() == [0] and not c.kq.any()  # raised before writing
    with pytest.raises(NotImplementedError):
        ops.paged_int8_attention(q, *[torch.zeros(3, 2, 8, 16, dtype=torch.int8),
                                      torch.ones(3, 2, 1, 8)] * 2,
                                 torch.zeros(1, 2, dtype=torch.int32),
                                 torch.zeros(1, dtype=torch.int32), sink_logits=torch.zeros(4))


# -- the tiny GPT-OSS -----------------------------------------------------------------


def _randomize(tree, rng):
    """Biases N(0, 0.5) and sinks N(0, 1), so that both are load-bearing
    (flax initializes them 0)."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out[k] = _randomize(v, rng)
        elif k in ("bias", "gate_up_proj_bias", "down_proj_bias"):
            out[k] = jnp.asarray(rng.normal(0, 0.5, np.shape(v)).astype(np.float32))
        elif k == "sinks":
            out[k] = jnp.asarray(rng.normal(0, 1, np.shape(v)).astype(np.float32))
        else:
            out[k] = v
    return out


_PAIRS = {}


def pair(mode="dynamic", factor=1.25):
    """The JAX model, its params and the port's model. Params do not depend
    on the capacity factor: every factor of a mode shares one init."""
    if (mode, factor) not in _PAIRS:
        dims = dict(OSS_DIMS, expert_capacity_factor=factor)
        jm = JLlamaModel(JModelConfig(**dims), mode=mode, dtype=jnp.float32)
        shared = next((v for (m, _), v in _PAIRS.items() if m == mode), None)
        if shared is None:
            params = jax.jit(jm.init)(jax.random.PRNGKey(11), jnp.zeros((1, 4), jnp.int32))
            params = _randomize(params, np.random.default_rng(11))
        else:
            params = shared[1]
        tm = LlamaModel(ModelConfig(**dims), mode=mode, dtype=torch.float32, device="cpu")
        tm.load_state_dict(params_from_numpy(to_numpy_tree(params)), strict=True)
        _PAIRS[mode, factor] = (jm, params, tm)
    return _PAIRS[mode, factor]


def _prompt(b, t, seed):
    return np.random.default_rng(seed).integers(1, OSS_DIMS["vocab_size"],
                                                (b, t)).astype(np.int32)


@pytest.fixture
def group16(monkeypatch):
    monkeypatch.setattr(jkv, "INT4_KV_GROUP", 16)
    monkeypatch.setattr(tkv, "INT4_KV_GROUP", 16)


def test_params_tree_loads_strict():
    """Sinks, the router and the stacked experts carry across by name."""
    jm, params, tm = pair()
    p = params["params"]["layers_1"]
    np.testing.assert_array_equal(tm.layers_1.self_attn.sinks.numpy(),
                                  np.asarray(p["self_attn"]["sinks"]))
    moe, jmoe = tm.layers_1.block_sparse_moe, p["block_sparse_moe"]
    np.testing.assert_array_equal(moe.gate.weight.numpy(), np.asarray(jmoe["gate"]["kernel"]).T)
    np.testing.assert_array_equal(moe.gate_up_proj.qweight.numpy(),
                                  np.swapaxes(np.asarray(jmoe["gate_up_proj"]["qkernel"].data),
                                              1, 2))
    np.testing.assert_array_equal(moe.down_proj_bias.numpy(), np.asarray(jmoe["down_proj_bias"]))
    assert not hasattr(tm.layers_1, "mlp")


@pytest.mark.parametrize("mode", ["dynamic", "fp"])
def test_scoring_logits_close(mode):
    jm, params, tm = pair(mode)
    tokens = _prompt(2, 10, seed=1)
    want = np.asarray(jm.apply(params, jnp.asarray(tokens)))
    np.testing.assert_allclose(tm(torch.from_numpy(tokens)).numpy(), want, atol=LOGIT_ATOL,
                               rtol=0)


@pytest.mark.parametrize("kv", ["bf16", "int8", "k4v8", "int4"])
def test_cache_prefill_and_decode_logits_close(group16, kv):
    """A 10-token prefill, then 6 decode steps fed the JAX model's tokens
    (past the window of 8; a KIVI cache flushes its first chunk of 16 at the
    last): every step's logits within LOGIT_ATOL, the sinks handed to both
    caches."""
    jm, params, tm = pair()
    tokens = _prompt(2, 10, seed=2)
    jc = j_init_cache(jm.cfg, 2, 32, kv_dtype=JAX_KV[kv])
    tc = init_cache(tm.cfg, 2, 32, "cpu", kv_dtype=kv)
    pos = np.broadcast_to(np.arange(10)[None], (2, 10)).astype(np.int32)
    want, jc = jm.apply(params, jnp.asarray(tokens), jnp.asarray(pos), jc)
    got = tm(torch.from_numpy(tokens), torch.from_numpy(pos), tc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_ATOL, rtol=0)
    for _ in range(6):
        tok = np.asarray(want)[:, -1].argmax(-1).astype(np.int32)[:, None]
        pos = np.array(jc[0].lengths)[:, None]
        want, jc = jm.apply(params, jnp.asarray(tok), jnp.asarray(pos), jc)
        got = tm(torch.from_numpy(tok), torch.from_numpy(pos), tc)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_ATOL, rtol=0)
    assert tc[0].lengths.tolist() == [16, 16]


@pytest.mark.parametrize("kv", ["int8", "int4"])
def test_greedy_tokens_identical(group16, kv):
    """Shapes as in the test above (batch 2, 10-token prompts, 32
    positions), so the eager JAX ops compiled there serve here too."""
    jm, params, tm = pair()
    prompt = _prompt(2, 10, seed=3)
    caches = j_init_cache(jm.cfg, 2, 32, kv_dtype=JAX_KV[kv])
    logits, caches = jm.apply(params, jnp.asarray(prompt), None, caches)
    want = []
    for _ in range(12):  # eagerly, one apply per step
        tok = np.asarray(logits)[:, -1].argmax(-1).astype(np.int32)[:, None]
        want.append(tok[:, 0])
        pos = np.asarray(caches[0].lengths)[:, None]
        logits, caches = jm.apply(params, jnp.asarray(tok), jnp.asarray(pos), caches)
    got = greedy_generate(tm, torch.from_numpy(prompt), 12, max_seq=32, kv_dtype=kv)
    np.testing.assert_array_equal(got.numpy(), np.stack(want, axis=1))


def _outputs(engine, prompts):
    rids = [engine.add_request(p) for p in prompts]
    out = engine.run()
    return [out[r] for r in rids]


@pytest.mark.parametrize("factor", [8.0, 1.25])
@pytest.mark.parametrize("kv", ["int8", "bf16", "k4v8", "int4"])
def test_engine_matches_jax_engine(group16, kv, factor):
    """Five requests over 4 slots, prompts past a prefill chunk and the
    window: tokens equal the JAX engine's. At factor 1.25 the decode steps
    drop expert assignments (idle slots compete for places too)."""
    jm, params, tm = pair(factor=factor)
    rng = np.random.default_rng(9)
    prompts = [list(map(int, rng.integers(1, OSS_DIMS["vocab_size"], n)))
               for n in (5, 20, 33, 9, 14)]
    kw = dict(max_batch_size=4, max_seq_len=64, prefill_chunk=16, max_new_tokens=10)
    want = _outputs(JEngine(jm, params, JEngineConfig(**kw), kv_dtype=JAX_KV[kv]), prompts)
    engine = Engine(tm, EngineConfig(**kw), kv_dtype=kv)
    moe = [layer.block_sparse_moe for layer in tm.layers]
    for m in moe:
        m.assignments, m.kept = 0, torch.zeros(())
    assert _outputs(engine, prompts) == want
    assert all(len(o) == 10 for o in want)
    dropped = sum(m.assignments - float(m.kept) for m in moe)
    assert (dropped > 0) == (factor == 1.25), dropped


@pytest.mark.parametrize("layout,kv", [("paged", "int8"), ("ring", "int8"), ("dense", "k8v4")])
def test_engine_refuses_layouts_without_sinks(layout, kv):
    tm = pair()[2]
    with pytest.raises(ValueError, match="learned attention sinks"):
        Engine(tm, EngineConfig(max_batch_size=2, max_seq_len=64, page_size=16),
               kv_layout=layout, kv_dtype=kv)


def test_fused_quant_fuses_only_the_input_norm(monkeypatch):
    """FUSED_QUANT=on on a MoE model: the input norms emit the projections'
    int8 input, the post-attention norms stay plain (the JAX gating), and
    the logits equal the unfused ones bit for bit on the CPU."""
    tm = pair()[2]
    calls = {"rms_norm_quant": 0}
    fn = ops.rms_norm_quant

    def counted(*a, **k):
        calls["rms_norm_quant"] += 1
        return fn(*a, **k)

    monkeypatch.setattr(ops, "rms_norm_quant", counted)
    tokens = torch.from_numpy(_prompt(2, 11, seed=6))
    want = tm(tokens)
    monkeypatch.setattr(ops, "FUSED_QUANT", "on")
    assert torch.equal(tm(tokens), want)
    assert calls["rms_norm_quant"] == OSS_DIMS["num_hidden_layers"]


def test_init_random_gpt_oss():
    m = LlamaModel(ModelConfig(**OSS_DIMS), mode="dynamic", dtype=torch.float32,
                   device="cpu").init_random_(0)
    moe = m.layers_0.block_sparse_moe
    assert not m.layers_0.self_attn.sinks.any() and not moe.gate_up_proj_bias.any()
    assert moe.gate_up_proj.qweight.any() and moe.gate_up_proj.qscale.shape == (8, 64)
    logits = m(torch.from_numpy(_prompt(1, 5, seed=0)))
    assert logits.shape == (1, 5, 86) and torch.isfinite(logits).all()
