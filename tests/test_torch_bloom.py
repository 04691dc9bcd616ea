"""The port's BLOOM family with ALiBi against the JAX package's: the ALiBi
variants of the paged, K4V8 and Int4 attentions' plain versions, the
``bloom_560m`` preset, and a tiny BLOOM (``BLOOM_TINY`` of
``tests/test_model_variants.py``) through scoring, the bf16, int8, K4V8,
Int4 and ring caches, greedy decoding and the dense, paged and ring engines.

Attention: the plain versions against the Pallas kernels in interpret mode,
the paged one within ATOL and the KIVI ones within TOL, as in
``test_torch_paged.py`` and ``test_torch_kivi_kv.py``. Models: float32 on
the CPU, weights carried by ``params_from_numpy``, with the biases and the
LayerNorms drawn at random so that they are load-bearing; logits within
LOGIT_ATOL (``test_torch_model.py``), greedy and engine tokens identical.
KIVI runs set INT4_KV_GROUP to 16 in both packages and drive the JAX model
eagerly, as ``test_torch_kivi_kv.py`` does. The tiny BLOOM has a config of
its own (vocab size), so no jitted JAX trace of another test's model is
reused.
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
from protoquant_tpu.models import LlamaModel as JLlamaModel
from protoquant_tpu.models.llama import init_cache as j_init_cache
from protoquant_tpu.ops.attention import int4_kv_attention as j_int4_attention
from protoquant_tpu.ops.attention import int8_kv_attention_xla as j_attention_xla
from protoquant_tpu.ops.attention import k4v8_attention as j_k4v8_attention
from protoquant_tpu.utils.config import ModelConfig as JModelConfig
from protoquant_tpu_torch import (Engine, EngineConfig, LlamaModel, ModelConfig,
                                  greedy_generate, ops, params_from_numpy)
from protoquant_tpu_torch.models import (Int8KVCache, MixedKVCache, RingInt8KVCache,
                                         cache_from_numpy, init_cache)
from protoquant_tpu_torch.models import kv_cache as tkv
from protoquant_tpu_torch.models.llama import LayerNorm, alibi_slopes
from test_torch_model import LOGIT_ATOL, to_numpy_tree

ATOL = 2e-5  # int8 attention, f32 on both sides (test_torch_ops.py)
TOL = 3e-5  # KIVI attention (test_torch_kivi_kv.py)

BLOOM_DIMS = dict(
    vocab_size=82, hidden_size=64, intermediate_size=256,
    num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=4,
    max_position_embeddings=64, norm_type="layernorm", mlp_gated=False,
    mlp_bias=True, attention_bias=True, attention_out_bias=True,
    hidden_act="gelu", position_embedding="alibi", embedding_layernorm=True,
    tie_word_embeddings=True,
)
JAX_KV = {"bf16": jnp.bfloat16, "int8": jnp.int8, "k4v8": "k4v8", "int4": jnp.int4}


def test_bloom_preset_matches_jax():
    port, ref = ModelConfig.bloom_560m(), JModelConfig.bloom_560m()
    for f in dataclasses.fields(port):
        assert getattr(port, f.name) == getattr(ref, f.name), f.name
    with pytest.raises(ValueError, match="position_embedding"):
        ModelConfig(position_embedding="learned")
    with pytest.raises(ValueError, match="norm_type"):
        ModelConfig(norm_type="groupnorm")


# -- the attentions' ALiBi variants ----------------------------------------------

KB, KKV, KH, KDH, KS, KG = 2, 2, 4, 16, 128, 16
KIVI_FIELDS = ("kq", "kchs", "vq", "vs", "ktail", "kts", "vtail", "vts")
KIVI = {"k4v8": (jkv.K4V8KVCache, tkv.K4V8KVCache, j_k4v8_attention, "k4v8_attention"),
        "int4": (jkv.Int4KVCache, tkv.Int4KVCache, j_int4_attention, "int4_kv_attention")}


@pytest.mark.parametrize("t_q", [1, 4])
@pytest.mark.parametrize("tier", KIVI)
def test_kivi_attention_alibi_vs_pallas(tier, t_q):
    """ALiBi over the packed store and the tail (lengths 100, frontier 96,
    and 30), against the JAX kernel in interpret mode."""
    jcls, tcls, j_attn, name = KIVI[tier]
    rng = np.random.default_rng(17 + t_q)
    before = np.array([100, 30], np.int32)
    rows = []
    for n in before:
        x = jnp.asarray(rng.standard_normal((1, n + t_q, KKV, KDH)).astype(np.float32) * 3)
        c = jcls.init(1, KS, KKV, KDH, group=KG).update(x[:, :n], x[:, :n])
        rows.append(c.update(x[:, n:], x[:, n:]))
    state = {f: np.concatenate([np.asarray(getattr(c, f)) for c in rows])
             for f in KIVI_FIELDS + ("lengths",)}
    q = rng.standard_normal((KB, t_q, KH, KDH)).astype(np.float32)
    slopes = alibi_slopes(KH)
    want = np.asarray(j_attn(jnp.asarray(q), *(jnp.asarray(state[f]) for f in KIVI_FIELDS),
                             jnp.asarray(before), jnp.asarray(state["lengths"]), group=KG,
                             alibi_slopes=jnp.asarray(slopes.numpy()), interpret=True))
    tc = cache_from_numpy(tcls, state, group=KG, device="cpu")
    args = (torch.from_numpy(q), *(getattr(tc, f) for f in KIVI_FIELDS),
            torch.from_numpy(before), tc.lengths)
    got = getattr(ops, name)(*args, group=KG, alibi_slopes=slopes)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    assert (got - getattr(ops, name)(*args, group=KG)).abs().max() > 1e-3


def test_k8v4_cache_refuses_alibi():
    c = MixedKVCache.init(1, 16, 2, 16, device="cpu")
    with pytest.raises(NotImplementedError):  # as the JAX K8V4 cache
        c.update_and_attend(torch.zeros(1, 1, 4, 16), torch.ones(1, 1, 2, 16),
                            torch.ones(1, 1, 2, 16), alibi_slopes=alibi_slopes(4))
    assert c.lengths.tolist() == [0] and not c.kq.any()  # raised before writing


def test_ring_alibi_matches_jax_ring_and_dense_windowed():
    """The ring with sinks and ALiBi, 30 decode steps through the wrap:
    every output against the JAX ring's and the port's dense windowed
    cache's (the bias reads the columns' absolute positions)."""
    rng = np.random.default_rng(14)
    B, KV, Dh, H, W, SINKS = 1, 2, 16, 4, 8, 2
    slopes = alibi_slopes(H)
    jring = jkv.RingInt8KVCache.init(B, W, 4, KV, Dh, sinks=SINKS)
    ring = RingInt8KVCache.init(B, W, 4, KV, Dh, sinks=SINKS, device="cpu")
    dense = Int8KVCache.init(B, 64, KV, Dh, device="cpu")
    for t in range(30):
        kv = rng.standard_normal((B, 1, KV, Dh)).astype(np.float32)
        q = rng.standard_normal((B, 1, H, Dh)).astype(np.float32)
        want, jring = jring.update_and_attend(jnp.asarray(q), jnp.asarray(kv), jnp.asarray(kv),
                                              alibi_slopes=jnp.asarray(slopes.numpy()))
        tq, tkv_ = torch.from_numpy(q), torch.from_numpy(kv)
        got = ring.update_and_attend(tq, tkv_, tkv_, alibi_slopes=slopes)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0,
                                   err_msg=f"step {t}")
        before = dense.lengths.clone()
        dense.update(tkv_, tkv_)
        flat = ops.int8_kv_attention_ref(tq, dense.kq, dense.ks, dense.vq, dense.vs, before,
                                         window=W, sinks=SINKS, alibi_slopes=slopes)
        torch.testing.assert_close(got, flat, atol=ATOL, rtol=0)
    want = j_attention_xla(jnp.asarray(q), jring.kq, jring.ks, jring.vq, jring.vs,
                           jring.lengths - 1, window=W)
    assert np.abs(np.asarray(want) - got.numpy()).max() > 1e-3  # sinks and ALiBi matter


# -- the tiny BLOOM --------------------------------------------------------------------


def _randomize(tree, rng):
    """Biases N(0, 0.05) and norm weights U[0.5, 1.5], so that both are
    load-bearing (flax initializes biases 0 and LayerNorm weights 1)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out[k] = _randomize(v, rng)
        elif k == "bias":
            out[k] = jnp.asarray(rng.normal(0, 0.05, np.shape(v)).astype(np.float32))
        elif k == "weight":
            out[k] = jnp.asarray(rng.uniform(0.5, 1.5, np.shape(v)).astype(np.float32))
        else:
            out[k] = v
    return out


_PAIRS = {}


def pair(mode="dynamic"):
    if mode not in _PAIRS:
        jm = JLlamaModel(JModelConfig(**BLOOM_DIMS), mode=mode, dtype=jnp.float32)
        params = jm.init(jax.random.PRNGKey(13), jnp.zeros((1, 4), jnp.int32))
        params = _randomize(params, np.random.default_rng(13))
        tm = LlamaModel(ModelConfig(**BLOOM_DIMS), mode=mode, dtype=torch.float32,
                        device="cpu")
        tm.load_state_dict(params_from_numpy(to_numpy_tree(params)), strict=True)
        _PAIRS[mode] = (jm, params, tm)
    return _PAIRS[mode]


def _prompt(b, t, seed):
    return np.random.default_rng(seed).integers(1, BLOOM_DIMS["vocab_size"],
                                                (b, t)).astype(np.int32)


@pytest.fixture
def group16(monkeypatch):
    monkeypatch.setattr(jkv, "INT4_KV_GROUP", 16)
    monkeypatch.setattr(tkv, "INT4_KV_GROUP", 16)


def test_params_tree_loads_strict():
    """A BLOOM params tree carries across by name: the embedding LayerNorm,
    every LayerNorm's weight and bias, the projections' biases."""
    jm, params, tm = pair()
    p = params["params"]
    assert isinstance(tm.embed_norm, LayerNorm) and isinstance(tm.norm, LayerNorm)
    for name, mod in (("embed_norm", tm.embed_norm), ("norm", tm.norm)):
        np.testing.assert_array_equal(mod.bias.numpy(), np.asarray(p[name]["bias"]))
    layer = p["layers_1"]
    np.testing.assert_array_equal(tm.layers_1.input_layernorm.weight.numpy(),
                                  np.asarray(layer["input_layernorm"]["weight"]))
    for mod, name in (("self_attn", "q_proj"), ("self_attn", "o_proj"),
                      ("mlp", "up_proj"), ("mlp", "down_proj")):
        np.testing.assert_array_equal(
            getattr(getattr(tm.layers_1, mod), name).bias.numpy(),
            np.asarray(layer[mod][name]["bias"]))
    assert not hasattr(tm.layers_1.mlp, "gate_proj")


@pytest.mark.parametrize("mode", ["dynamic", "fp"])
def test_scoring_logits_close(mode):
    jm, params, tm = pair(mode)
    tokens = _prompt(2, 12, seed=1)
    want = np.asarray(jm.apply(params, jnp.asarray(tokens)))
    np.testing.assert_allclose(tm(torch.from_numpy(tokens)).numpy(), want, atol=LOGIT_ATOL,
                               rtol=0)


@pytest.mark.parametrize("kv", ["bf16", "int8", "k4v8", "int4"])
@pytest.mark.parametrize("mode", ["dynamic", "fp"])
def test_cache_prefill_and_decode_logits_close(group16, mode, kv):
    """A 10-token prefill, then 8 decode steps fed the JAX model's tokens
    (a KIVI cache flushes its first chunk of 16 on the way): every step's
    logits within LOGIT_ATOL, the ALiBi slopes handed to both caches."""
    jm, params, tm = pair(mode)
    tokens = _prompt(2, 10, seed=2)
    jc = j_init_cache(jm.cfg, 2, 32, kv_dtype=JAX_KV[kv])
    tc = init_cache(tm.cfg, 2, 32, "cpu", kv_dtype=kv)
    pos = np.broadcast_to(np.arange(10)[None], (2, 10)).astype(np.int32)
    want, jc = jm.apply(params, jnp.asarray(tokens), jnp.asarray(pos), jc)
    got = tm(torch.from_numpy(tokens), torch.from_numpy(pos), tc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_ATOL, rtol=0)
    for _ in range(8):
        tok = np.asarray(want)[:, -1].argmax(-1).astype(np.int32)[:, None]
        pos = np.array(jc[0].lengths)[:, None]
        want, jc = jm.apply(params, jnp.asarray(tok), jnp.asarray(pos), jc)
        got = tm(torch.from_numpy(tok), torch.from_numpy(pos), tc)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_ATOL, rtol=0)
    assert tc[0].lengths.tolist() == [18, 18]


@pytest.mark.parametrize("kv", ["int8", "int4"])
def test_greedy_tokens_identical(group16, kv):
    jm, params, tm = pair()
    prompt = _prompt(2, 13, seed=3)
    caches = j_init_cache(jm.cfg, 2, 64, kv_dtype=JAX_KV[kv])
    logits, caches = jm.apply(params, jnp.asarray(prompt), None, caches)
    want = []
    for _ in range(20):  # eagerly, one apply per step
        tok = np.asarray(logits)[:, -1].argmax(-1).astype(np.int32)[:, None]
        want.append(tok[:, 0])
        pos = np.asarray(caches[0].lengths)[:, None]
        logits, caches = jm.apply(params, jnp.asarray(tok), jnp.asarray(pos), caches)
    got = greedy_generate(tm, torch.from_numpy(prompt), 20, max_seq=64, kv_dtype=kv)
    np.testing.assert_array_equal(got.numpy(), np.stack(want, axis=1))


def _outputs(engine, prompts):
    rids = [engine.add_request(p) for p in prompts]
    out = engine.run()
    return [out[r] for r in rids]


ENGINES = {  # name: (EngineConfig extras, kv_layout, kv_dtype)
    "dense-int8": ({}, "dense", "int8"),
    "dense-k4v8": ({}, "dense", "k4v8"),
    "paged-int8": ({"page_size": 16}, "paged", "int8"),
    "ring-streaming": ({"stream_window": 12, "attention_sinks": 4}, "ring", "int8"),
}


@pytest.mark.parametrize("name", ENGINES)
def test_engine_matches_jax_engine(group16, name):
    """More requests than slots, prompts past a prefill chunk and (ring)
    past the 12-token serving window: tokens equal the JAX engine's. The
    paged layout's decode runs the page walk with the slopes, its prefill
    the dense attention over the gathered window."""
    extra, layout, kv = ENGINES[name]
    jm, params, tm = pair()
    rng = np.random.default_rng(9)
    prompts = [list(map(int, rng.integers(1, BLOOM_DIMS["vocab_size"], n)))
               for n in (5, 20, 33)]
    kw = dict(max_batch_size=2, max_seq_len=64, prefill_chunk=16, max_new_tokens=12, **extra)
    jkw = {} if layout == "dense" else {"kv_layout": layout}
    want = _outputs(JEngine(jm, params, JEngineConfig(**kw), kv_dtype=JAX_KV[kv], **jkw),
                    prompts)
    engine = Engine(tm, EngineConfig(**kw), kv_layout=layout, kv_dtype=kv)
    assert _outputs(engine, prompts) == want
    assert all(len(o) == 12 for o in want)
    if layout == "ring":
        assert all(isinstance(c, RingInt8KVCache) and c.sinks == 4 for c in engine.caches)


@pytest.fixture
def spy(monkeypatch):
    """Calls of the quantizing ops by name (the launch counters count CUDA
    launches only)."""
    calls = {"rms_norm_quant": 0, "swiglu_quant": 0, "rowquant": 0}
    for name in calls:
        fn = getattr(ops, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(ops, name, counted)
    return calls


def test_fused_quant_fuses_nothing_on_layernorm(monkeypatch, spy):
    """FUSED_QUANT=on with LayerNorm and a plain MLP: no norm is fused and
    there is no gate (the JAX model's gating), so the model runs no
    producer and equals the unfused one bit for bit."""
    tm = pair()[2]
    tokens = torch.from_numpy(_prompt(2, 11, seed=6))
    want = (tm(tokens), greedy_generate(tm, tokens, 6, 32, kv_dtype="int8"))
    layers = BLOOM_DIMS["num_hidden_layers"]
    assert spy["rowquant"] == (4 * layers + 1) * 7  # scoring, prefill, 5 decode steps
    spy["rowquant"] = 0
    monkeypatch.setattr(ops, "FUSED_QUANT", "on")
    got = (tm(tokens), greedy_generate(tm, tokens, 6, 32, kv_dtype="int8"))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert spy == {"rms_norm_quant": 0, "swiglu_quant": 0, "rowquant": (4 * layers + 1) * 7}


def test_init_random_norms_and_biases():
    m = LlamaModel(ModelConfig(**BLOOM_DIMS), mode="dynamic", dtype=torch.float32,
                   device="cpu").init_random_(0)
    assert torch.equal(m.embed_norm.weight, torch.ones(64)) and not m.embed_norm.bias.any()
    assert not m.layers_0.self_attn.q_proj.bias.any()
    assert m.layers_0.self_attn.alibi_slopes.tolist() == alibi_slopes(4).tolist()
    logits = m(torch.from_numpy(_prompt(1, 5, seed=0)))
    assert logits.shape == (1, 5, 82) and torch.isfinite(logits).all()
