"""The port's Gemma-2 and Mistral paths against the JAX package's: the
sliding-window, score-scale and softcap variants of the attention kernels'
plain versions, and tiny Gemma-2 and Mistral models through scoring, greedy
decoding and the engines.

Attention, as in ``test_torch_ops.py`` and ``test_torch_kivi_kv.py``: the
int8 plain version against ``int8_kv_attention_xla`` and the Pallas kernel
in interpret mode within ATOL; the KIVI plain versions against the Pallas
kernels within TOL (rtol and atol); the K8V4 one with its score scale as
the int8 one. Both sides sum in f32 in different orders, and the Pallas
kernels scale after the dot and cap by a multiply by 1/cap where the plain
versions divide: a few ulps of outputs of magnitude ~1. q is drawn large
enough that the scores reach past the softcap, so the cap bites.

Models: float32 on the CPU, weights carried by ``params_from_numpy``;
logits within LOGIT_ATOL (``test_torch_model.py``), greedy and engine
tokens identical. The tiny Gemma-2 is shaped like the JAX package's
``GEMMA2_TINY`` (``tests/test_model_variants.py``) with both softcaps
lowered so that they bite at its random weights; each model has a config
of its own (vocab size), so no jitted JAX trace of another test's model is
reused. KIVI runs set INT4_KV_GROUP to 16 in both packages and drive the
JAX model eagerly, as ``test_torch_kivi_kv.py`` does.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import protoquant_tpu.models.kv_cache as jkv
from protoquant_tpu import ops as jops
from protoquant_tpu.engine import Engine as JEngine
from protoquant_tpu.engine import EngineConfig as JEngineConfig
from protoquant_tpu.models import LlamaModel as JLlamaModel
from protoquant_tpu.models.llama import init_cache as j_init_cache
from protoquant_tpu.ops.attention import int4_kv_attention as j_int4_attention
from protoquant_tpu.ops.attention import int8_kv_attention as j_attention
from protoquant_tpu.ops.attention import int8_kv_attention_xla as j_attention_xla
from protoquant_tpu.ops.attention import k4v8_attention as j_k4v8_attention
from protoquant_tpu.ops.attention import mixed_kv_attention as j_mixed_attention
from protoquant_tpu.utils.config import ModelConfig as JModelConfig
from protoquant_tpu_torch import (Engine, EngineConfig, LlamaModel, ModelConfig,
                                  greedy_generate, ops, params_from_numpy)
from protoquant_tpu_torch.models import cache_from_numpy, init_cache
from protoquant_tpu_torch.models import kv_cache as tkv
from test_torch_model import LOGIT_ATOL, to_numpy_tree

ATOL = 2e-5  # int8 attention, f32 on both sides (test_torch_ops.py)
TOL = 3e-5  # KIVI attention (test_torch_kivi_kv.py)

# (window, scale, softcap) of the JAX package's variant cases
# (tests/test_attention.py): a window across blocks, one narrower than the
# query chunk (rows with disjoint windows), the Gemma query scale, and
# Gemma-2's three together.
INT8_CASES = {
    "window-t1": (1, dict(window=200)),
    "window-t4": (4, dict(window=200)),
    "tiny_window-t4": (4, dict(window=2)),
    "scale-t1": (1, dict(scale=0.25)),
    "gemma2-t4": (4, dict(window=300, scale=0.125, softcap=30.0)),
}


def _int8_cache(rng, B, KV, S, Dh):
    kq = rng.integers(-127, 128, (B, KV, S, Dh)).astype(np.int8)
    vq = rng.integers(-127, 128, (B, KV, S, Dh)).astype(np.int8)
    ks = rng.uniform(0.005, 0.02, (B, KV, S)).astype(np.float32)
    vs = rng.uniform(0.005, 0.02, (B, KV, S)).astype(np.float32)
    return kq, ks, vq, vs


def _capped_q(rng, shape, q_scale):
    """q large enough that the largest scores pass twice the softcap."""
    return (rng.standard_normal(shape) * q_scale).astype(np.float32)


@pytest.mark.parametrize("case", INT8_CASES)
def test_int8_attention_variants_vs_xla_and_pallas(case):
    t_q, kw = INT8_CASES[case]
    B, KV, group, S, Dh = 2, 2, 2, 1024, 64
    rng = np.random.default_rng(11)
    kq, ks, vq, vs = _int8_cache(rng, B, KV, S, Dh)
    # one slot deep into the second 512-block, one whose window reaches 0
    lengths = np.array([S - 30, 70], np.int32)
    q = _capped_q(rng, (B, t_q, KV * group, Dh), 40.0)
    args = [q, kq, ks, vq, vs, lengths]
    j_xla = np.asarray(j_attention_xla(*map(jnp.asarray, args), **kw))
    j_kernel = np.asarray(j_attention(*map(jnp.asarray, args), interpret=True, **kw))
    got = ops.int8_kv_attention(*map(torch.from_numpy, args), **kw).numpy()
    np.testing.assert_allclose(got, j_xla, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, j_kernel, atol=ATOL, rtol=0)
    if "softcap" in kw:  # the cap bites: without it the output moves
        sm = kw["scale"]
        raw = np.einsum("btkgd,bksd->bkgts", (q * sm).reshape(B, t_q, KV, group, Dh),
                        kq.astype(np.float32)) * ks[:, :, None, None, :]
        assert np.abs(raw).max() > 2 * kw["softcap"]
        uncapped = ops.int8_kv_attention(*map(torch.from_numpy, args), window=kw["window"],
                                         scale=sm).numpy()
        assert np.abs(uncapped - got).max() > 1e-2


def test_int8_attention_window_is_a_mask():
    """A window as wide as the context changes nothing; under a narrower
    one, each query sees exactly the keys of a cache cut to start at its
    window (the window masks, it does not shift positions)."""
    rng = np.random.default_rng(12)
    B, KV, S, Dh, T, W = 1, 1, 64, 32, 3, 5
    kq, ks, vq, vs = map(torch.from_numpy, _int8_cache(rng, B, KV, S, Dh))
    q = torch.from_numpy(rng.standard_normal((B, T, 2, Dh)).astype(np.float32))
    lengths = torch.tensor([40], dtype=torch.int32)
    full = ops.int8_kv_attention_ref(q, kq, ks, vq, vs, lengths)
    assert torch.equal(ops.int8_kv_attention_ref(q, kq, ks, vq, vs, lengths, window=S), full)
    win = ops.int8_kv_attention(q, kq, ks, vq, vs, lengths, window=W)
    for t in range(T):
        lo = 40 + t - W + 1
        cut = [x[:, :, lo:] for x in (kq, ks, vq, vs)]
        alone = ops.int8_kv_attention_ref(q[:, t:t + 1], *cut, lengths + t - lo)
        torch.testing.assert_close(win[:, t:t + 1], alone, atol=1e-6, rtol=0)
    assert not torch.allclose(win, full, atol=1e-3)
    with pytest.raises(ValueError, match="window"):
        ops.int8_kv_attention(q, kq, ks, vq, vs, lengths, window=-1)


# -- the KIVI and K8V4 caches -------------------------------------------------------

KB, KKV, KH, KDH, KS, KG = 2, 2, 4, 16, 128, 16
KIVI_FIELDS = ("kq", "kchs", "vq", "vs", "ktail", "kts", "vtail", "vts")
KIVI = {"k4v8": (jkv.K4V8KVCache, tkv.K4V8KVCache, j_k4v8_attention, "k4v8_attention"),
        "int4": (jkv.Int4KVCache, tkv.Int4KVCache, j_int4_attention, "int4_kv_attention")}
# windows scaled to S = 128 and G = 16: one reaching into the packed store,
# one narrower than the query chunk, the scale alone, and all three
KIVI_CASES = {
    "window-t1": (1, dict(window=40)),
    "window-t4": (4, dict(window=40)),
    "tiny_window-t4": (4, dict(window=2)),
    "scale-t1": (1, dict(scale=0.25)),
    "gemma2-t4": (4, dict(window=50, scale=0.125, softcap=5.0)),
}


@pytest.mark.parametrize("case", KIVI_CASES)
@pytest.mark.parametrize("tier", KIVI)
def test_kivi_attention_variants_vs_pallas(tier, case):
    """The plain attention with each variant against the JAX kernel in
    interpret mode: lengths 100 (frontier 96, the window reaching 60 into
    the packed store) and 30, the step's writes in the cache."""
    jcls, tcls, j_attn, name = KIVI[tier]
    t_q, kw = KIVI_CASES[case]
    rng = np.random.default_rng(13 + t_q)
    before = np.array([100, 30], np.int32)
    rows = []  # one batch-1 JAX cache per row, then stacked
    for n in before:
        x = jnp.asarray(rng.standard_normal((1, n + t_q, KKV, KDH)).astype(np.float32) * 3)
        c = jcls.init(1, KS, KKV, KDH, group=KG).update(x[:, :n], x[:, :n])
        rows.append(c.update(x[:, n:], x[:, n:]))
    state = {f: np.concatenate([np.asarray(getattr(c, f)) for c in rows])
             for f in KIVI_FIELDS + ("lengths",)}
    q = _capped_q(rng, (KB, t_q, KH, KDH), 4.0)
    want = np.asarray(j_attn(jnp.asarray(q), *(jnp.asarray(state[f]) for f in KIVI_FIELDS),
                             jnp.asarray(before), jnp.asarray(state["lengths"]),
                             group=KG, interpret=True, **kw))
    tc = cache_from_numpy(tcls, state, group=KG, device="cpu")
    got = getattr(ops, name)(torch.from_numpy(q), *(getattr(tc, f) for f in KIVI_FIELDS),
                             torch.from_numpy(before), tc.lengths, group=KG, **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    if "softcap" in kw:
        uncapped = getattr(ops, name)(torch.from_numpy(q),
                                      *(getattr(tc, f) for f in KIVI_FIELDS),
                                      torch.from_numpy(before), tc.lengths, group=KG,
                                      window=kw["window"], scale=kw["scale"])
        assert (uncapped - got).abs().max() > 1e-2


@pytest.mark.parametrize("t_q", [1, 4])
def test_mixed_attention_scale_vs_pallas(t_q):
    B, KV, S, Dh = 2, 2, 64, 32
    rng = np.random.default_rng(14 + t_q)
    kq = rng.integers(-127, 128, (B, KV, S, Dh)).astype(np.int8)
    vq = rng.integers(-128, 128, (B, KV, S // 2, Dh)).astype(np.int8)
    ks = rng.uniform(0.005, 0.02, (B, KV, S)).astype(np.float32)
    vs = rng.uniform(0.005, 0.02, (B, KV, 2, S // 2)).astype(np.float32)
    lengths = np.array([S - t_q, 17], np.int32)
    q = rng.standard_normal((B, t_q, KV * 2, Dh)).astype(np.float32) * 4
    args = [q, kq, ks, vq, vs, lengths]
    want = np.asarray(j_mixed_attention(*map(jnp.asarray, args), scale=0.1, interpret=True))
    got = ops.mixed_kv_attention(*map(torch.from_numpy, args), scale=0.1).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    plain = ops.mixed_kv_attention_ref(*map(torch.from_numpy, args)).numpy()
    assert np.abs(plain - got).max() > 1e-3  # the scale took effect


def test_k8v4_cache_refuses_window_and_softcap():
    c = tkv.MixedKVCache.init(1, 16, 2, 16, device="cpu")
    for kw in ({"window": 4}, {"softcap": 5.0}):  # the JAX K8V4 cache raises too
        with pytest.raises(NotImplementedError):
            c.update_and_attend(torch.zeros(1, 1, 4, 16), torch.zeros(1, 1, 2, 16),
                                torch.zeros(1, 1, 2, 16), **kw)
    assert c.lengths.tolist() == [0] and not c.kq.any()  # raised before writing


# -- the models ---------------------------------------------------------------------

GEMMA2_DIMS = dict(
    vocab_size=68, hidden_size=64, intermediate_size=128,
    num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
    max_position_embeddings=64, rms_norm_eps=1e-6,
    tie_word_embeddings=True, hidden_act="gelu_tanh",
    rmsnorm_unit_offset=True, scale_embeddings=True, head_dim_override=32,
    query_pre_attn_scalar=16.0, attn_logit_softcap=1.0,
    final_logit_softcap=2.0, sliding_window=4,
    alternating_sliding_window=True, sandwich_norms=True,
)
MISTRAL_DIMS = dict(
    vocab_size=70, hidden_size=64, intermediate_size=128,
    num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
    max_position_embeddings=64, sliding_window=5,
)
FAMILIES = {"gemma2": GEMMA2_DIMS, "mistral": MISTRAL_DIMS}


def _norm_weights(tree, seed):
    """Every norm weight of a flax params tree drawn from [-0.5, 0.5]
    (zero-centred weights of 0, the init, would hide a missing + 1)."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out[k] = _norm_weights(v, seed + len(out) + 1)
        elif k == "weight":
            out[k] = jnp.asarray(rng.uniform(-0.5, 0.5, np.shape(v)).astype(np.float32))
        else:
            out[k] = v
    return out


def _pair(family, mode):
    dims = FAMILIES[family]
    jm = JLlamaModel(JModelConfig(**dims), mode=mode, dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(5), jnp.zeros((1, 4), jnp.int32))
    params = _norm_weights(params, 1)
    tm = LlamaModel(ModelConfig(**dims), mode=mode, dtype=torch.float32, device="cpu")
    tm.load_state_dict(params_from_numpy(to_numpy_tree(params)), strict=True)
    return jm, params, tm


_PAIRS = {}


def pair(family, mode="dynamic"):
    if (family, mode) not in _PAIRS:
        _PAIRS[family, mode] = _pair(family, mode)
    return _PAIRS[family, mode]


def _prompt(family, b, t, seed):
    vocab = FAMILIES[family]["vocab_size"]
    return np.random.default_rng(seed).integers(1, vocab, (b, t)).astype(np.int32)


def test_presets_and_layer_windows():
    from protoquant_tpu.utils.config import ModelConfig as J

    for name in ("gemma2_9b", "mistral_7b"):
        port, ref = getattr(ModelConfig, name)(), getattr(J, name)()
        for f in dataclasses.fields(port):
            assert getattr(port, f.name) == getattr(ref, f.name), (name, f.name)
    g = ModelConfig.gemma2_9b()
    assert g.head_dim == 256 and [g.layer_window(i) for i in range(4)] == [4096, 0, 4096, 0]
    assert ModelConfig.mistral_7b().layer_window(7) == 4096
    assert ModelConfig(sliding_window=8, sliding_window_pattern=3).layer_window(2) == 0
    with pytest.raises(ValueError, match="hidden_act"):
        ModelConfig(hidden_act="gelu_exact")
    m = LlamaModel(ModelConfig(**GEMMA2_DIMS), mode="fp", dtype=torch.float32, device="cpu")
    m.init_random_(0)
    # zero-centred norms start at 0 (the identity), with the sandwich norms there
    assert not m.layers_1.pre_feedforward_layernorm.weight.any()
    assert not m.norm.weight.any()
    attn = [layer.self_attn.variants for layer in m.layers]
    assert attn == [{"window": 4, "scale": 0.25, "softcap": 1.0},
                    {"window": 0, "scale": 0.25, "softcap": 1.0}]


@pytest.mark.parametrize("mode", ["dynamic", "fp"])
@pytest.mark.parametrize("family", FAMILIES)
def test_scoring_logits_close(family, mode):
    jm, params, tm = pair(family, mode)
    # seed 0 moves one Mistral activation code by a step (see LOGIT_ATOL)
    tokens = _prompt(family, 2, 12, seed=1)
    want = np.asarray(jm.apply(params, jnp.asarray(tokens)))
    got = tm(torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, want, atol=LOGIT_ATOL, rtol=0)
    if family == "gemma2":  # the final cap bites: logits stay inside it
        assert np.abs(got).max() < GEMMA2_DIMS["final_logit_softcap"]
        assert np.abs(got).max() > 0.5 * GEMMA2_DIMS["final_logit_softcap"]


JAX_KV = {"bf16": jnp.bfloat16, "int8": jnp.int8, "k4v8": "k4v8"}


@pytest.fixture
def group16(monkeypatch):
    monkeypatch.setattr(jkv, "INT4_KV_GROUP", 16)
    monkeypatch.setattr(tkv, "INT4_KV_GROUP", 16)


@pytest.mark.parametrize("kv", ["bf16", "int8", "k4v8"])
@pytest.mark.parametrize("mode", ["dynamic", "fp"])
@pytest.mark.parametrize("family", FAMILIES)
def test_cache_prefill_and_decode_logits_close(group16, family, mode, kv):
    """A 10-token prefill, then 6 decode steps fed the JAX model's tokens
    (the K4V8 cache flushes its first chunk of 16 on the way): every step's
    logits within LOGIT_ATOL, the window passed by both."""
    jm, params, tm = pair(family, mode)
    tokens = _prompt(family, 2, 10, seed=2)
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


def _j_greedy_eager(jm, params, prompt, steps, kv_dtype):
    """The JAX model's greedy decode, one eager ``apply`` per step."""
    caches = j_init_cache(jm.cfg, prompt.shape[0], 64, kv_dtype=kv_dtype)
    logits, caches = jm.apply(params, jnp.asarray(prompt), None, caches)
    out = []
    for _ in range(steps):
        tok = np.asarray(logits)[:, -1].argmax(-1).astype(np.int32)[:, None]
        out.append(tok[:, 0])
        pos = np.asarray(caches[0].lengths)[:, None]
        logits, caches = jm.apply(params, jnp.asarray(tok), jnp.asarray(pos), caches)
    return np.stack(out, axis=1)


@pytest.mark.parametrize("kv", ["bf16", "int8", "k4v8"])
@pytest.mark.parametrize("family", FAMILIES)
def test_greedy_tokens_identical(group16, family, kv):
    jm, params, tm = pair(family)
    prompt = _prompt(family, 2, 13, seed=3)
    want = _j_greedy_eager(jm, params, prompt, 20, JAX_KV[kv])
    got = greedy_generate(tm, torch.from_numpy(prompt), 20, max_seq=64, kv_dtype=kv)
    np.testing.assert_array_equal(got.numpy(), want)


def _engine_outputs(engine, prompts):
    rids = [engine.add_request(p) for p in prompts]
    out = engine.run()
    return [out[r] for r in rids]


@pytest.mark.parametrize("layout,kv", [("dense", "int8"), ("dense", "k4v8"),
                                       ("paged", "int8")])
@pytest.mark.parametrize("family", FAMILIES)
def test_engine_matches_jax_engine(group16, family, layout, kv):
    """Prompts longer than the window, more requests than slots, prompts
    longer than a prefill chunk; the paged layout's decode steps run the
    dense kernel over the gathered window, as the JAX cache sends them to
    its gathered path."""
    jm, params, tm = pair(family)
    vocab = FAMILIES[family]["vocab_size"]
    rng = np.random.default_rng(9)
    prompts = [list(map(int, rng.integers(1, vocab, n))) for n in (5, 20, 33)]
    kw = dict(max_batch_size=2, max_seq_len=64, prefill_chunk=16, max_new_tokens=9)
    extra = {"page_size": 16} if layout == "paged" else {}
    jkw = {"kv_layout": "paged"} if layout == "paged" else {}
    want = _engine_outputs(JEngine(jm, params, JEngineConfig(**kw, **extra),
                                   kv_dtype=JAX_KV[kv], **jkw), prompts)
    engine = Engine(tm, EngineConfig(**kw, **extra), kv_layout=layout, kv_dtype=kv)
    assert _engine_outputs(engine, prompts) == want
    assert all(len(o) == 9 for o in want)


@pytest.fixture
def spy(monkeypatch):
    """Calls of the fused ops by name (the launch counters count CUDA
    launches only)."""
    calls = {"rms_norm_quant": 0, "swiglu_quant": 0, "rowquant": 0}
    for name in calls:
        fn = getattr(ops, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(ops, name, counted)
    return calls


def test_fused_quant_under_sandwich_norms(monkeypatch, spy):
    """FUSED_QUANT=on with sandwich norms: no norm is fused (the JAX
    model's gating), the GeGLU gate is, and on the CPU the model equals the
    unfused one bit for bit."""
    m = LlamaModel(ModelConfig(**GEMMA2_DIMS), mode="dynamic", dtype=torch.float32,
                   device="cpu").init_random_(4)
    g = torch.Generator().manual_seed(4)
    for name, mod in m.named_modules():
        if name.endswith("layernorm") or name == "norm":
            mod.weight.copy_(torch.rand(mod.weight.shape, generator=g) - 0.5)
    tokens = torch.from_numpy(_prompt("gemma2", 2, 11, seed=6))
    want = (m(tokens), greedy_generate(m, tokens, 6, 32, kv_dtype="int8"))
    unfused_rowquant = spy["rowquant"]
    layers = GEMMA2_DIMS["num_hidden_layers"]
    assert unfused_rowquant == (4 * layers + 1) * 7  # scoring, prefill, 5 decode steps
    spy["rowquant"] = 0
    monkeypatch.setattr(ops, "FUSED_QUANT", "on")
    got = (m(tokens), greedy_generate(m, tokens, 6, 32, kv_dtype="int8"))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert spy == {"rms_norm_quant": 0, "swiglu_quant": layers * 7,
                   "rowquant": (3 * layers + 1) * 7}


def test_fused_gemma2_matches_fused_jax(monkeypatch):
    """The fused port model against the fused JAX model (the JAX knob is
    read at trace time): scoring logits within LOGIT_ATOL."""
    monkeypatch.setattr(jops, "FUSED_QUANT", "on")
    monkeypatch.setattr(ops, "FUSED_QUANT", "on")
    dims = dict(GEMMA2_DIMS, vocab_size=74)
    jm = JLlamaModel(JModelConfig(**dims), mode="dynamic", dtype=jnp.float32)
    params = _norm_weights(jm.init(jax.random.PRNGKey(6), jnp.zeros((1, 4), jnp.int32)), 2)
    tm = LlamaModel(ModelConfig(**dims), mode="dynamic", dtype=torch.float32, device="cpu")
    tm.load_state_dict(params_from_numpy(to_numpy_tree(params)), strict=True)
    tokens = np.random.default_rng(7).integers(1, 74, (2, 9)).astype(np.int32)
    want = np.asarray(jm.apply(params, jnp.asarray(tokens)))
    np.testing.assert_allclose(tm(torch.from_numpy(tokens)).numpy(), want,
                               atol=LOGIT_ATOL, rtol=0)


def test_params_tree_loads_strict():
    """A Gemma-2 params tree carries across by name: the sandwich norms'
    weights, zero-centred as stored."""
    jm, params, tm = pair("gemma2")
    p = params["params"]["layers_1"]
    for name in ("input_layernorm", "post_attention_layernorm",
                 "pre_feedforward_layernorm", "post_feedforward_layernorm"):
        np.testing.assert_array_equal(getattr(tm.layers_1, name).weight.numpy(),
                                      np.asarray(p[name]["weight"]))
    assert tm.layers_1.input_layernorm.weight.min() < 0  # stored, not + 1
