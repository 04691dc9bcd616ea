"""The port's ring KV layout against the JAX package's: the ring-position,
StreamingLLM-sink and ALiBi variants of the int8 attention's plain version,
``RingInt8KVCache``, and ``Engine(kv_layout="ring")`` over tiny Mistral,
StreamingLLM Llama and Gemma-2 hybrid models.

Attention, as in ``test_torch_gemma2.py``: the plain version against
``int8_kv_attention_xla`` and the Pallas kernel in interpret mode within
ATOL (both sides sum in f32 in different orders). The ring caches of the
two packages hold the same codes and scales bit for bit (the JAX cache runs
eagerly, so its quantizer divides); their outputs, and those of the port's
ring and dense windowed caches, agree within ATOL. The engines emit the
same greedy tokens. Each model has a config of its own (vocab size), so no
jitted JAX trace of another test's model is reused.

Fault F2 is pinned here: with sinks over a contiguous cache the port keeps
the sink keys visible, as ``int8_kv_attention_xla`` does, where the Pallas
kernel skips the tiles below the window and drops them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import protoquant_tpu.models.kv_cache as jkv
from protoquant_tpu.engine import Engine as JEngine
from protoquant_tpu.engine import EngineConfig as JEngineConfig
from protoquant_tpu.models import LlamaModel as JLlamaModel
from protoquant_tpu.models.llama import alibi_slopes as j_alibi_slopes
from protoquant_tpu.ops.attention import int8_kv_attention as j_attention
from protoquant_tpu.ops.attention import int8_kv_attention_xla as j_attention_xla
from protoquant_tpu.utils.config import ModelConfig as JModelConfig
from protoquant_tpu_torch import Engine, EngineConfig, LlamaModel, ModelConfig, ops
from protoquant_tpu_torch.models import (Int8KVCache, RingInt8KVCache, cache_from_numpy,
                                         params_from_numpy, ring_positions)
from protoquant_tpu_torch.models.llama import alibi_slopes
from test_torch_model import to_numpy_tree

ATOL = 2e-5  # int8 attention, f32 on both sides (test_torch_ops.py)
RING_FIELDS = ("kq", "ks", "vq", "vs", "lengths")


def _int8_cache(rng, B, KV, S, Dh):
    kq = rng.integers(-127, 128, (B, KV, S, Dh)).astype(np.int8)
    vq = rng.integers(-127, 128, (B, KV, S, Dh)).astype(np.int8)
    ks = rng.uniform(0.005, 0.02, (B, KV, S)).astype(np.float32)
    vs = rng.uniform(0.005, 0.02, (B, KV, S)).astype(np.float32)
    return kq, ks, vq, vs


def _j_ring_positions(lengths_after, C, sinks):
    """The JAX ring's column positions (``RingInt8KVCache.update_and_attend``)."""
    L = jnp.asarray(lengths_after)[:, None]
    c = jnp.arange(C)[None, :]
    if sinks == 0:
        return (L - 1) - ((L - 1 - c) % C)
    R = C - sinks
    rot = (L - 1) - ((L - 1 - sinks - (c - sinks)) % R)
    rot = jnp.where(rot >= sinks, rot, -1)
    return jnp.where(c < sinks, jnp.where(c < L, c, -1), rot)


def _check(got, args, kw):
    """The port's output against the XLA formulation and the Pallas kernel
    in interpret mode, on the same numpy inputs."""
    jargs = [jnp.asarray(a) for a in args]
    jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    want_xla = np.asarray(j_attention_xla(*jargs, **jkw))
    want_kernel = np.asarray(j_attention(*jargs, interpret=True, **jkw))
    np.testing.assert_allclose(got, want_xla, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, want_kernel, atol=ATOL, rtol=0)


def _port(args, kw):
    tkw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    return ops.int8_kv_attention(*map(torch.from_numpy, args), **tkw).numpy()


@pytest.mark.parametrize("heads", [4, 12, 16, 20, 32])
def test_alibi_slopes_match_jax(heads):
    np.testing.assert_array_equal(alibi_slopes(heads).numpy(), j_alibi_slopes(heads))


@pytest.mark.parametrize("t_q", [1, 4])
def test_int8_attention_alibi_vs_xla_and_pallas(t_q):
    """The JAX package's ALiBi cases (tests/test_attention.py): S = 1024,
    one slot deep into the second block, one short."""
    B, KV, G, S, Dh = 2, 2, 2, 1024, 64
    rng = np.random.default_rng(11)
    kq, ks, vq, vs = _int8_cache(rng, B, KV, S, Dh)
    q = (rng.standard_normal((B, t_q, KV * G, Dh)) * 0.5).astype(np.float32)
    args = [q, kq, ks, vq, vs, np.array([S - 30, 70], np.int32)]
    kw = {"alibi_slopes": alibi_slopes(KV * G).numpy()}
    got = _port(args, kw)
    _check(got, args, kw)
    assert np.abs(got - _port(args, {})).max() > 1e-3  # the bias took effect


@pytest.mark.parametrize("alibi", [False, True])
@pytest.mark.parametrize("sinks,t_q", [(0, 1), (0, 4), (4, 1), (4, 4)])
def test_int8_attention_ring_positions_vs_xla_and_pallas(sinks, t_q, alibi):
    """Ring positions (a long stream wrapped many times, a short one with
    most columns never written), with and without StreamingLLM sinks and
    ALiBi, as the JAX package's ring case."""
    B, KV, G, C, Dh, W = 2, 2, 2, 256, 64, 128
    rng = np.random.default_rng(21)
    kq, ks, vq, vs = _int8_cache(rng, B, KV, C, Dh)
    q = (rng.standard_normal((B, t_q, KV * G, Dh)) * 0.5).astype(np.float32)
    lengths = np.array([1000, 30], np.int32)
    k_pos = ring_positions(torch.from_numpy(lengths) + t_q, C, sinks)
    np.testing.assert_array_equal(k_pos.numpy(), _j_ring_positions(lengths + t_q, C, sinks))
    assert (k_pos[1] < 0).any() and (k_pos[0] >= 0).all()  # row 1: columns never written
    assert k_pos[0].max() == 1000 + t_q - 1
    kw = {"window": W, "k_positions": k_pos.numpy(), "sinks": sinks}
    if alibi:
        kw["alibi_slopes"] = alibi_slopes(KV * G).numpy()
    args = [q, kq, ks, vq, vs, lengths]
    got = _port(args, kw)
    _check(got, args, kw)
    # the positions are read: taken as column indices, the output moves
    as_columns = {k: v for k, v in kw.items() if k != "k_positions"}
    assert np.abs(got - _port(args, as_columns)).max() > 1e-3


def test_sinks_on_contiguous_cache_follow_xla_not_pallas():
    """Fault F2, pinned: sinks with a window over a contiguous cache (no
    positions). The port keeps positions < sinks visible, as the XLA
    formulation does; the Pallas kernel skips the tiles below the window
    and so drops them (no JAX caller passes sinks without positions)."""
    B, KV, G, S, Dh = 1, 1, 2, 1024, 64
    rng = np.random.default_rng(31)
    kq, ks, vq, vs = _int8_cache(rng, B, KV, S, Dh)
    q = rng.standard_normal((B, 1, KV * G, Dh)).astype(np.float32)
    args = [q, kq, ks, vq, vs, np.array([994], np.int32)]
    kw = {"window": 200, "sinks": 4}
    got = _port(args, kw)
    jargs = [jnp.asarray(a) for a in args]
    xla = np.asarray(j_attention_xla(*jargs, **kw))
    kernel = np.asarray(j_attention(*jargs, interpret=True, **kw))
    np.testing.assert_allclose(got, xla, atol=ATOL, rtol=0)
    assert np.abs(kernel - xla).max() > 1e-3  # the Pallas kernel drops the sinks
    np.testing.assert_allclose(kernel, _port(args, {"window": 200}), atol=ATOL, rtol=0)


# -- RingInt8KVCache ---------------------------------------------------------------


@pytest.mark.parametrize("sinks", [0, 4])
def test_ring_cache_matches_jax_ring_and_dense_windowed(sinks):
    """Chunks of 7 and 1 tokens through the wrap (the JAX package's sink
    case): every step's output against the JAX ring's (within ATOL) and the
    port's dense int8 cache under the same window and sinks; the two rings'
    codes, scales and lengths bit for bit."""
    rng = np.random.default_rng(7)
    B, KV, H, Dh, W = 2, 2, 4, 16, 6
    jring = jkv.RingInt8KVCache.init(B, W, max_chunk=7, kv_heads=KV, head_dim=Dh, sinks=sinks)
    ring = RingInt8KVCache.init(B, W, 7, KV, Dh, sinks=sinks, device="cpu")
    assert ring.capacity == jring.capacity == 32 and ring.sinks == sinks
    dense = Int8KVCache.init(B, 64, KV, Dh, device="cpu")
    total = 0
    for t in [7, 7, 1, 1, 7, 1, 1, 7, 1]:  # 33 tokens: wraps the ring
        q, k, v = (rng.standard_normal((B, t, n, Dh)).astype(np.float32) for n in (H, KV, KV))
        want, jring = jring.update_and_attend(*map(jnp.asarray, (q, k, v)))
        got = ring.update_and_attend(*map(torch.from_numpy, (q, k, v)))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0,
                                   err_msg=f"length {total}")
        for f in RING_FIELDS:
            np.testing.assert_array_equal(getattr(ring, f).numpy(), np.asarray(getattr(jring, f)))
        before = dense.lengths.clone()
        dense.update(torch.from_numpy(k), torch.from_numpy(v))
        flat = ops.int8_kv_attention_ref(torch.from_numpy(q), dense.kq, dense.ks, dense.vq,
                                         dense.vs, before, window=W, sinks=sinks)
        torch.testing.assert_close(got, flat, atol=ATOL, rtol=0)
        total += t
    assert total > ring.capacity


def test_ring_cache_slots_and_guards():
    """A slot view writes into the ring; reset zeroes one length; a chunk
    past the slack raises before anything is written."""
    ring = RingInt8KVCache.init(2, 6, 7, 2, 16, sinks=2, device="cpu")
    x = torch.randn(1, 5, 2, 16)
    view = ring.slot_view(1)
    view.update(x, x)
    ring.merge_slot(view, 1)
    assert ring.lengths.tolist() == [0, 5] and ring.kq[1, :, :5].any() and not ring.kq[0].any()
    assert ring._column(torch.tensor([0, 1, 2, 31, 32])).tolist() == [0, 1, 2, 31, 2]
    with pytest.raises(ValueError, match="slack"):
        ring.update(torch.randn(2, 25, 2, 16), torch.randn(2, 25, 2, 16))  # slack 24
    assert ring.lengths.tolist() == [0, 5]
    ring.reset_slot(1)
    assert ring.lengths.tolist() == [0, 0]
    with pytest.raises(NotImplementedError):
        ring.update_and_attend(torch.zeros(2, 1, 4, 16), x[:1, :1].expand(2, 1, 2, 16),
                               x[:1, :1].expand(2, 1, 2, 16), sink_logits=torch.zeros(4))


def test_cache_from_numpy_carries_meta_fields():
    jring = jkv.RingInt8KVCache.init(1, 5, 4, 2, 16, sinks=3)
    tc = cache_from_numpy(RingInt8KVCache, {f: np.asarray(getattr(jring, f))
                                             for f in RING_FIELDS},
                          window=jring.window, sinks=jring.sinks, device="cpu")
    assert (tc.window, tc.sinks, tc.capacity) == (5, 3, jring.capacity)
    assert tc.kq.device.type == "cpu"


# -- the ring engine ------------------------------------------------------------------

MISTRAL_DIMS = dict(vocab_size=76, hidden_size=64, intermediate_size=128,
                    num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                    max_position_embeddings=64, sliding_window=5)
# a window-free model with q/k/v biases (the JAX package's QWEN2_TINY shape)
QWEN2_DIMS = dict(vocab_size=78, hidden_size=64, intermediate_size=128,
                  num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                  max_position_embeddings=64, rope_theta=1e6, attention_bias=True)
GEMMA2_DIMS = dict(vocab_size=80, hidden_size=64, intermediate_size=128,
                   num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                   max_position_embeddings=64, rms_norm_eps=1e-6, tie_word_embeddings=True,
                   hidden_act="gelu_tanh", rmsnorm_unit_offset=True, scale_embeddings=True,
                   head_dim_override=32, query_pre_attn_scalar=16.0, attn_logit_softcap=1.0,
                   final_logit_softcap=2.0, sliding_window=4,
                   alternating_sliding_window=True, sandwich_norms=True)
_PAIRS = {}


def _randomize(tree, rng):
    """Biases drawn N(0, 0.05), so the bias path is load-bearing."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out[k] = _randomize(v, rng)
        elif k == "bias":
            out[k] = jnp.asarray(rng.normal(0, 0.05, np.shape(v)).astype(np.float32))
        else:
            out[k] = v
    return out


def pair(dims, mode="dynamic"):
    key = (dims["vocab_size"], mode)
    if key not in _PAIRS:
        jm = JLlamaModel(JModelConfig(**dims), mode=mode, dtype=jnp.float32)
        params = jm.init(jax.random.PRNGKey(2), jnp.zeros((1, 4), jnp.int32))
        params = _randomize(params, np.random.default_rng(3))
        tm = LlamaModel(ModelConfig(**dims), mode=mode, dtype=torch.float32, device="cpu")
        tm.load_state_dict(params_from_numpy(to_numpy_tree(params)), strict=True)
        _PAIRS[key] = (jm, params, tm)
    return _PAIRS[key]


def _outputs(engine, prompts):
    rids = [engine.add_request(p) for p in prompts]
    out = engine.run()
    return [out[r] for r in rids]


def _ring_vs_jax(dims, prompts, **cfg):
    jm, params, tm = pair(dims)
    want = _outputs(JEngine(jm, params, JEngineConfig(**cfg), kv_dtype=jnp.int8,
                            kv_layout="ring"), prompts)
    engine = Engine(tm, EngineConfig(**cfg), kv_layout="ring")
    got = _outputs(engine, prompts)
    assert got == want
    assert all(len(o) == cfg["max_new_tokens"] for o in got)
    return engine, got


def test_ring_engine_mistral_matches_jax_and_dense():
    """A uniform window of 5 on both layers: the ring (32 columns) wraps
    past 40 tokens; tokens equal the JAX ring engine's and the port's dense
    engine's."""
    rng = np.random.default_rng(5)
    prompts = [list(map(int, rng.integers(1, 76, n))) for n in (20, 9, 26)]
    cfg = dict(max_batch_size=2, max_seq_len=64, prefill_chunk=7, max_new_tokens=20)
    engine, got = _ring_vs_jax(MISTRAL_DIMS, prompts, **cfg)
    assert all(isinstance(c, RingInt8KVCache) and c.capacity == 32 for c in engine.caches)
    dense = Engine(pair(MISTRAL_DIMS)[2], EngineConfig(**cfg))
    assert _outputs(dense, prompts) == got


def test_ring_engine_streaming_window_free_model():
    """StreamingLLM serving of a model without a window: stream_window 12,
    4 sinks; 74 tokens through a ring of 32 columns, positions past the
    model's 64 clamped as in the JAX engine."""
    cfg = dict(max_batch_size=1, max_seq_len=128, prefill_chunk=7, max_new_tokens=60,
               stream_window=12, attention_sinks=4)
    engine, _ = _ring_vs_jax(QWEN2_DIMS, [list(range(1, 15))], **cfg)
    assert engine.caches[0].capacity == 32 and engine.caches[0].sinks == 4


def test_ring_engine_bucket_slack():
    """Prefill pieces pad to 16-token buckets: the ring's slack covers the
    padded piece (the JAX package's regression case)."""
    cfg = dict(max_batch_size=1, max_seq_len=64, prefill_chunk=8, max_new_tokens=30,
               stream_window=16, attention_sinks=4)
    engine, _ = _ring_vs_jax(QWEN2_DIMS, [list(range(1, 20))], **cfg)
    assert engine.caches[0].capacity - engine.caches[0].window - 4 >= 16


def test_ring_engine_gemma2_hybrid():
    """Gemma-2 on the ring layout: a ring on the sliding layer 0, a dense
    int8 cache on the global layer 1; tokens equal the JAX ring engine's and
    the port's dense engine's."""
    rng = np.random.default_rng(6)
    prompts = [list(map(int, rng.integers(1, 80, n))) for n in (17, 5, 30)]
    cfg = dict(max_batch_size=2, max_seq_len=64, prefill_chunk=8, max_new_tokens=12)
    engine, got = _ring_vs_jax(GEMMA2_DIMS, prompts, **cfg)
    assert [type(c) for c in engine.caches] == [RingInt8KVCache, Int8KVCache]
    assert engine.caches[0].window == 4 and engine.caches[1].max_seq == 64
    dense = Engine(pair(GEMMA2_DIMS)[2], EngineConfig(**cfg))
    assert _outputs(dense, prompts) == got


def test_ring_engine_guards():
    tm = pair(QWEN2_DIMS)[2]
    with pytest.raises(ValueError, match="sliding_window"):
        Engine(tm, EngineConfig(max_batch_size=2, max_seq_len=64), kv_layout="ring")
    with pytest.raises(ValueError, match="int8 only"):
        Engine(tm, EngineConfig(max_batch_size=2, max_seq_len=64, stream_window=8),
               kv_layout="ring", kv_dtype="k4v8")
