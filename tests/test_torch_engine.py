"""The port's continuous-batching engine against the JAX package's.

Same weights (carried by ``params_from_numpy``), float32, dense int8 KV
cache, greedy sampling: the two engines must emit identical tokens, with
more requests than slots (queueing and slot reuse), prompts longer than one
prefill chunk, and a slot whose padded prefill bucket reaches past
``max_seq_len``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from protoquant_tpu.engine import Engine as JEngine
from protoquant_tpu.engine import EngineConfig as JEngineConfig
from protoquant_tpu.models import LlamaModel as JLlamaModel
from protoquant_tpu.utils.config import ModelConfig as JModelConfig
from protoquant_tpu_torch import (Engine, EngineConfig, LlamaModel, ModelConfig,
                                  greedy_generate, params_from_numpy)
from test_torch_model import DIMS, to_numpy_tree


@pytest.fixture(scope="module")
def pair():
    jm = JLlamaModel(JModelConfig(**DIMS), mode="dynamic", dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(3), jnp.zeros((1, 4), jnp.int32))
    tm = LlamaModel(ModelConfig(**DIMS), mode="dynamic", dtype=torch.float32,
                    device="cpu")
    tm.load_state_dict(params_from_numpy(to_numpy_tree(params)), strict=True)
    return jm, params, tm


def _prompts(lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(1, DIMS["vocab_size"], n))) for n in lengths]


def _run_both(pair, prompts, max_batch_size, max_seq_len, max_new_tokens=8):
    jm, params, tm = pair
    kw = dict(max_batch_size=max_batch_size, max_seq_len=max_seq_len,
              prefill_chunk=16, max_new_tokens=max_new_tokens)
    je = JEngine(jm, params, JEngineConfig(**kw), kv_dtype=jnp.int8)
    te = Engine(tm, EngineConfig(**kw))
    jr = [je.add_request(p) for p in prompts]
    tr = [te.add_request(p) for p in prompts]
    jout, tout = je.run(), te.run()
    return [jout[r] for r in jr], [tout[r] for r in tr], te


def test_engine_matches_jax_engine(pair):
    prompts = _prompts([3, 20, 9])  # 20 spans two prefill chunks
    want, got, te = _run_both(pair, prompts, max_batch_size=2, max_seq_len=64)
    assert got == want
    m = te.metrics()
    assert m["prefills"] == 3 and m["tokens_generated"] == 24
    assert m["queue_depth"] == 0 and m["prefilling"] == 0


def test_engine_batched_equals_sequential(pair):
    _, _, tm = pair
    prompts = _prompts([5, 11, 2, 17], seed=1)
    e = Engine(tm, EngineConfig(max_batch_size=3, max_seq_len=64,
                                prefill_chunk=16, max_new_tokens=6))
    rids = [e.add_request(p) for p in prompts]
    out = e.run()
    for rid, p in zip(rids, prompts):
        alone = greedy_generate(tm, torch.tensor([p]), 6, 64, kv_dtype="int8")
        assert out[rid] == alone[0].tolist()


def test_slot_near_max_seq_len_does_not_fault(pair):
    # 35 prompt tokens in chunks of 16: the last piece pads to 16 rows at
    # positions 32..47, past max_seq_len=40; those writes must be dropped.
    prompts = _prompts([35, 4], seed=2)
    want, got, te = _run_both(pair, prompts, max_batch_size=2, max_seq_len=40)
    assert got == want
    assert len(got[0]) == 40 - 35  # retired at max_seq_len
    assert all(c.lengths.max().item() <= 40 for c in te.caches)


def test_sampling_filters_match_jax():
    from protoquant_tpu.engine.sampling import processed_logits as j_processed
    from protoquant_tpu.engine.sampling import token_logprob as j_logprob
    from protoquant_tpu_torch.engine.sampling import processed_logits, sample_batched
    from protoquant_tpu_torch.engine import token_logprob

    rng = np.random.default_rng(5)
    logits = (rng.standard_normal((5, 40)) * 3).astype(np.float32)
    temps = np.array([0.0, 0.7, 1.0, 1.3, 0.5], np.float32)
    top_ks = np.array([0, 5, 0, 12, 1], np.int32)
    top_ps = np.array([1.0, 0.9, 0.5, 1.0, 1.0], np.float32)
    min_ps = np.array([0.0, 0.0, 0.1, 0.05, 0.0], np.float32)
    want = np.asarray(j_processed(*map(jnp.asarray, (logits, temps, top_ks, top_ps, min_ps))))
    t = [torch.from_numpy(a) for a in (logits, temps, top_ks, top_ps, min_ps)]
    got = processed_logits(*t).numpy()
    np.testing.assert_array_equal(got <= -1e29, want <= -1e29)  # same tokens kept
    kept = want > -1e29
    np.testing.assert_allclose(got[kept], want[kept], rtol=1e-6)
    toks = np.array([3, 0, 39, 7, 11], np.int32)
    np.testing.assert_allclose(
        token_logprob(t[0], torch.from_numpy(toks)).numpy(),
        np.asarray(j_logprob(jnp.asarray(logits), jnp.asarray(toks))), atol=1e-5)
    gen = torch.Generator().manual_seed(0)
    for _ in range(20):
        draw = sample_batched(t[0], gen, *t[1:]).numpy()
        assert draw[0] == logits[0].argmax()  # temperature 0: greedy
        assert kept[np.arange(5), draw].all()  # draws stay inside the filter
