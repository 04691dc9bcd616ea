"""The port's K8V4 cache (``MixedKVCache``) and bf16 cache (``BF16KVCache``)
against the JAX package's.

K8V4 keeps K as the int8 cache does and V as int4 nibbles per token,
packed by token pair, with parity-split scales. ``quantize_kv4``, the plain
decode writer (against ``kv_mixed_scatter_decode(interpret=True)`` and the
JAX cache's XLA write) and the cache state after every step are held bit
for bit: both sides divide ``amax / 7`` and ``x / s`` truly and round half
to even. The JAX caches run eagerly, because under ``jit`` XLA:CPU
multiplies by 1/7 and 1/127 instead. Attention is held to rtol 1e-5 and
atol 1e-6, the JAX test's own limits for its kernel against the XLA
formulation (``tests/test_mixed_kv.py``): both sum in f32 in different
orders. The models and engines emit the same greedy tokens.

One difference is deliberate and pinned here: a padded prefill whose pad
rows reach past S clamps their V writes onto position S - 1 in the JAX
cache (``pos_t = min(s, S - 1)``), where its decode writer and the port
drop them.

``BF16KVCache`` is plain PyTorch on both sides (no TPU kernel backs it);
its outputs are held to rtol 1e-5 and atol 1e-6 too (the same f32 sums in
other orders), and it is ``init_cache``'s and ``greedy_generate``'s default,
as in the JAX package.
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
from protoquant_tpu.models import greedy_generate as j_greedy
from protoquant_tpu.models.llama import init_cache as j_init_cache
from protoquant_tpu.ops.attention import mixed_kv_attention as j_mixed_attention
from protoquant_tpu.ops.kv_scatter import kv_mixed_scatter_decode as j_mixed_writer
from protoquant_tpu.utils.config import ModelConfig as JModelConfig
from protoquant_tpu_torch import (Engine, EngineConfig, LlamaModel, ModelConfig,
                                  greedy_generate, ops, params_from_numpy)
from protoquant_tpu_torch.models import (BF16KVCache, MixedKVCache, cache_from_numpy,
                                         init_cache)
from protoquant_tpu_torch.models.kv_cache import quantize_kv4
from test_torch_model import DIMS, to_numpy_tree

RTOL, ATOL = 1e-5, 1e-6
FIELDS = ("kq", "ks", "vq", "vs", "lengths")
B, KV, H, DH, S = 2, 2, 4, 16, 64


def _port(jc):
    """The port cache holding the JAX cache's state."""
    return cache_from_numpy(MixedKVCache, {f: np.asarray(getattr(jc, f)) for f in FIELDS},
                            device="cpu")


def _same(tc, jc):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(tc, f).numpy(), np.asarray(getattr(jc, f)),
                                      err_msg=f)


def _filled(rng, fill, S=S):
    jc = jkv.MixedKVCache.init(B, S, KV, DH)
    if fill:
        x = jnp.asarray(rng.standard_normal((B, fill, KV, DH)), jnp.float32)
        jc = jc.update(x, x * 0.5)
    return jc


def test_quantize_kv4_bitwise():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 3, 32)).astype(np.float32) * 3
    x[0, 2, 1] = 0  # an all-zero token: the scale floor
    x[1, 4, 0, :5] = [3.5, -3.5, 2.5, 0.5, -7.0]  # ties at amax 7: half to even
    want = jkv.quantize_kv4(jnp.asarray(x))
    got = quantize_kv4(torch.from_numpy(x))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0].dtype == torch.int8 and got[0].abs().max() <= 7
    assert got[1][0, 2, 1].item() == np.float32(1e-12)


@pytest.mark.parametrize("fill", [10, 11, 12, 13, 0, S])
def test_decode_writer_matches_jax(fill):
    """The plain writer against the JAX writer in interpret mode, in place;
    below S also against the JAX cache's XLA write. Row 1 at length 5 takes
    the high nibble; row 0 at ``fill`` the low or high one, or nothing at
    S (the writers drop it; the XLA write would clamp it to S - 1)."""
    rng = np.random.default_rng(3 + fill)
    jc = _filled(rng, max(fill, 5))
    lengths = np.asarray([fill, 5], np.int32)
    jc = jkv.MixedKVCache(jc.kq, jc.ks, jc.vq, jc.vs, jnp.asarray(lengths))
    k = rng.standard_normal((B, 1, KV, DH)).astype(np.float32)
    v = rng.standard_normal((B, 1, KV, DH)).astype(np.float32)
    k8, ks_new = jkv.quantize_kv(jnp.asarray(k))
    v4, vs_new = jkv.quantize_kv4(jnp.asarray(v))
    new = [np.swapaxes(np.asarray(a), 1, 2).copy() for a in (k8, ks_new, v4, vs_new)]
    want = j_mixed_writer(jc.kq, jc.ks, jc.vq, jc.vs, jc.lengths, *map(jnp.asarray, new),
                          interpret=True)
    tc = _port(jc)
    before = [getattr(tc, f).clone() for f in FIELDS[:-1]]
    ops.reset_launch_counts()
    got = ops.kv_mixed_scatter_decode(tc.kq, tc.ks, tc.vq, tc.vs, tc.lengths,
                                      *map(torch.from_numpy, new))
    assert not any(ops.launch_counts().values())  # the CPU takes the plain version
    for name, w, g, b0 in zip(FIELDS, want, got, before):
        assert g.data_ptr() == getattr(tc, name).data_ptr()  # in place
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
        # row 1 (length 5) always writes; row 0 only below S
        assert not torch.equal(g[1], b0[1]) and torch.equal(g[0], b0[0]) == (fill == S)
    if fill < S:
        xla = jc.update(jnp.asarray(k), jnp.asarray(v), jnp.zeros(B, jnp.int32))
        for name, g in zip(FIELDS, got):
            np.testing.assert_array_equal(g.numpy(), np.asarray(getattr(xla, name)),
                                          err_msg=name)


@pytest.mark.parametrize("T", [1, 33])
def test_attention_plain_vs_pallas_and_xla(T):
    """The plain attention against the JAX kernel in interpret mode (f32
    lanes) and against the JAX cache's XLA ``update_and_attend``; GQA H = 4
    over KV = 2, an odd and an even length."""
    rng = np.random.default_rng(5 + T)
    jc = _filled(rng, 30)
    jc = jkv.MixedKVCache(jc.kq, jc.ks, jc.vq, jc.vs, jnp.asarray([29, 30], jnp.int32))
    q, k, v = (rng.standard_normal((B, T, h, DH)).astype(np.float32) for h in (H, KV, KV))
    j_out, jn = jc.update_and_attend(*map(jnp.asarray, (q, k, v)))
    want = np.asarray(j_mixed_attention(jnp.asarray(q), jn.kq, jn.ks, jn.vq, jn.vs,
                                        jc.lengths, interpret=True))
    tc = _port(jc)
    ops.reset_launch_counts()
    got = tc.update_and_attend(*map(torch.from_numpy, (q, k, v)))
    assert not any(ops.launch_counts().values())
    _same(tc, jn)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(j_out), rtol=RTOL, atol=ATOL)
    plain = ops.mixed_kv_attention_ref(torch.from_numpy(q), tc.kq, tc.ks, tc.vq, tc.vs,
                                       torch.tensor([29, 30], dtype=torch.int32))
    assert torch.equal(plain, got)


def test_cache_updates_match_jax():
    """Prefill, padded prefill (advance < T), decode in both parities, an
    idle row (advance 0), a prefill from an odd length: every field equal
    after each step, outputs within the limits; all below S."""
    rng = np.random.default_rng(1)
    jc = jkv.MixedKVCache.init(B, S, KV, DH)
    tc = MixedKVCache.init(B, S, KV, DH, device="cpu")

    def step(jc, T, advance=None):
        q, k, v = (rng.standard_normal((B, T, h, DH)).astype(np.float32) for h in (H, KV, KV))
        adv = None if advance is None else np.asarray(advance, np.int32)
        jout, jc = jc.update_and_attend(*map(jnp.asarray, (q, k, v)),
                                        None if adv is None else jnp.asarray(adv))
        tout = tc.update_and_attend(*map(torch.from_numpy, (q, k, v)),
                                    None if adv is None else torch.from_numpy(adv))
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=RTOL, atol=ATOL)
        _same(tc, jc)
        return jc

    jc = step(jc, 13)
    jc = step(jc, 16, advance=[9, 16])  # row 0 keeps 9 of 16: its pad rows stay masked
    for adv in ([1, 1], [1, 0], [1, 1], [1, 1]):
        jc = step(jc, 1, advance=adv)
    jc = step(jc, 7)  # from lengths 26 / 32
    assert tc.lengths.tolist() == [33, 39]


def test_reference_clamps_v_past_S():
    """S = 8: 6 tokens, then a 4-row piece keeping 2. The JAX prefill write
    clamps the pad rows' V onto position 7 (vq and vs change there; K past
    S is dropped); the port drops them, as the decode writers do, and ends
    equal to an exact 8-token fill."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((1, 10, KV, DH)).astype(np.float32)
    y = rng.standard_normal((1, 10, KV, DH)).astype(np.float32)

    def jax_cache(pieces):
        c = jkv.MixedKVCache.init(1, 8, KV, DH)
        for a, b, adv in pieces:
            c = c.update(jnp.asarray(x[:, a:b]), jnp.asarray(y[:, a:b]),
                         jnp.asarray([adv], jnp.int32))
        return c

    exact = jax_cache([(0, 6, 6), (6, 8, 2)])
    padded = jax_cache([(0, 6, 6), (6, 10, 2)])
    np.testing.assert_array_equal(np.asarray(padded.kq), np.asarray(exact.kq))
    assert not np.array_equal(np.asarray(padded.vq), np.asarray(exact.vq))
    assert not np.array_equal(np.asarray(padded.vs), np.asarray(exact.vs))
    tc = MixedKVCache.init(1, 8, KV, DH, device="cpu")
    tc.update(torch.from_numpy(x[:, :6]), torch.from_numpy(y[:, :6]))
    tc.update(torch.from_numpy(x[:, 6:10]), torch.from_numpy(y[:, 6:10]),
              torch.tensor([2], dtype=torch.int32))
    _same(tc, exact)


def test_attention_variants_not_ported_raise():
    c = MixedKVCache.init(1, 16, 1, 16, device="cpu")
    q = torch.zeros(1, 1, 2, 16)
    for fn in (ops.mixed_kv_attention, ops.mixed_kv_attention_ref):
        for kw in ({"window": 4}, {"softcap": 5.0},
                   {"alibi_slopes": torch.ones(2)}, {"sink_logits": torch.zeros(2)},
                   {"tree_mask": torch.ones(1, 1)}):
            with pytest.raises(NotImplementedError):
                fn(q, *(getattr(c, f) for f in FIELDS), **kw)


def test_init_checks_and_slots():
    with pytest.raises(ValueError, match="even max_seq"):
        MixedKVCache.init(1, 45, 1, 16, device="cpu")
    c = MixedKVCache.init(3, 32, 2, 16, device="cpu")
    assert c.kq.shape == (3, 2, 32, 16) and c.ks.shape == (3, 2, 32)
    assert c.vq.shape == (3, 2, 16, 16) and c.vs.shape == (3, 2, 2, 16)
    small = MixedKVCache.init(1, 32, 2, 16, device="cpu")
    small.update(torch.randn(1, 11, 2, 16), torch.randn(1, 11, 2, 16))
    c.merge_slot(small, 2)
    for f in FIELDS:
        assert torch.equal(getattr(c, f)[2:3], getattr(small, f)), f
    view = c.slot_view(1)
    assert type(view) is MixedKVCache
    view.update(torch.ones(1, 5, 2, 16), torch.ones(1, 5, 2, 16))
    assert c.lengths.tolist() == [0, 5, 11] and c.vq[1].any() and not c.vq[0].any()
    c.reset_slot(1)
    assert c.lengths.tolist() == [0, 0, 11]
    nib, scales = c._unpack_v()
    assert nib.shape == (3, 2, 32, 16) and scales.shape == (3, 2, 32)
    assert torch.equal(nib[2:3], small._unpack_v()[0])


# -- the bf16 cache ----------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_bf16_cache_matches_jax(dtype):
    """Prefill, padded prefill, decode with an idle row and a prefill past S,
    through both caches: k/v and lengths equal, outputs within the limits."""
    rng = np.random.default_rng(12)
    jc = jkv.BF16KVCache.init(B, 32, KV, DH, getattr(jnp, dtype))
    tc = BF16KVCache.init(B, 32, KV, DH, dtype=getattr(torch, dtype), device="cpu")
    for T, adv in ((11, None), (16, [5, 16]), (1, [1, 0]), (1, [1, 1]), (16, [16, 3])):
        q, k, v = (rng.standard_normal((B, T, h, DH)).astype(np.float32) for h in (H, KV, KV))
        a = None if adv is None else np.asarray(adv, np.int32)
        jout, jc = jc.update_and_attend(*map(jnp.asarray, (q, k, v)),
                                        None if a is None else jnp.asarray(a))
        tout = tc.update_and_attend(*map(torch.from_numpy, (q, k, v)),
                                    None if a is None else torch.from_numpy(a))
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=RTOL, atol=ATOL)
        for f in ("k", "v", "lengths"):
            np.testing.assert_array_equal(getattr(tc, f).float().numpy(),
                                          np.asarray(getattr(jc, f)).astype(np.float32))
    assert tc.lengths.tolist() == [34, 31]
    view = tc.slot_view(1)
    assert type(view) is BF16KVCache and view.k.data_ptr() == tc.k[1].data_ptr()


# -- the models and the engines --------------------------------------------------------

MIXED_DIMS = dict(DIMS, vocab_size=84)  # a config of its own: no JAX trace reused


@pytest.fixture(scope="module")
def mixed_pair():
    jm = JLlamaModel(JModelConfig(**MIXED_DIMS), mode="dynamic", dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(17), jnp.zeros((1, 4), jnp.int32))
    tm = LlamaModel(ModelConfig(**MIXED_DIMS), mode="dynamic", dtype=torch.float32,
                    device="cpu")
    tm.load_state_dict(params_from_numpy(to_numpy_tree(params)), strict=True)
    return jm, params, tm


def _prompt(b, t, seed):
    return np.random.default_rng(seed).integers(1, MIXED_DIMS["vocab_size"], (b, t)).astype(
        np.int32)


def _j_greedy_eager(jm, params, prompt, steps, kv_dtype, max_seq=64):
    """The JAX model's greedy decode, one eager ``apply`` per step (under
    ``jit`` XLA:CPU quantizes K/V with a reciprocal multiply)."""
    caches = j_init_cache(jm.cfg, prompt.shape[0], max_seq, kv_dtype=kv_dtype)
    logits, caches = jm.apply(params, jnp.asarray(prompt), None, caches)
    out = []
    for _ in range(steps):
        tok = np.asarray(logits)[:, -1].argmax(-1).astype(np.int32)[:, None]
        out.append(tok[:, 0])
        pos = np.asarray(caches[0].lengths)[:, None]
        logits, caches = jm.apply(params, jnp.asarray(tok), jnp.asarray(pos), caches)
    return np.stack(out, axis=1)


def test_greedy_tokens_identical_k8v4(mixed_pair):
    jm, params, tm = mixed_pair
    prompt = _prompt(2, 13, seed=8)
    want = _j_greedy_eager(jm, params, prompt, 20, "k8v4")
    got = greedy_generate(tm, torch.from_numpy(prompt), 20, max_seq=64, kv_dtype="k8v4")
    np.testing.assert_array_equal(got.numpy(), want)
    # T + max_new_tokens = 33 is odd: both packages refuse the cache
    with pytest.raises(ValueError, match="even max_seq"):
        j_greedy(jm, params, jnp.asarray(prompt), 20, kv_dtype="k8v4")
    with pytest.raises(ValueError, match="even max_seq"):
        greedy_generate(tm, torch.from_numpy(prompt), 20, kv_dtype="k8v4")


def _engine_outputs(engine, prompts):
    rids = [engine.add_request(p) for p in prompts]
    out = engine.run()
    return [out[r] for r in rids]


def test_engine_matches_jax_engine_k8v4(mixed_pair):
    jm, params, tm = mixed_pair
    rng = np.random.default_rng(9)
    prompts = [list(map(int, rng.integers(1, MIXED_DIMS["vocab_size"], n)))
               for n in (5, 20, 33)]
    kw = dict(max_batch_size=2, max_seq_len=64, prefill_chunk=16, max_new_tokens=9)
    want = _engine_outputs(JEngine(jm, params, JEngineConfig(**kw), kv_dtype="k8v4"), prompts)
    engine = Engine(tm, EngineConfig(**kw), kv_dtype="k8v4")
    assert type(engine.caches[0]) is MixedKVCache
    assert _engine_outputs(engine, prompts) == want
    assert all(len(o) == 9 for o in want)
    with pytest.raises(ValueError, match="paged"):  # the paged layout is int8 only
        Engine(tm, EngineConfig(**kw, page_size=16), kv_layout="paged", kv_dtype="k8v4")


def test_greedy_default_is_bf16_as_jax(mixed_pair):
    """greedy_generate's default cache is the JAX package's (bf16): the
    same tokens as the JAX greedy decode with its default, and as an
    engine over a bf16 cache, batched."""
    jm, params, tm = mixed_pair
    prompt = _prompt(2, 7, seed=10)
    want = np.asarray(j_greedy(jm, params, jnp.asarray(prompt), 12, 32))
    got = greedy_generate(tm, torch.from_numpy(prompt), 12, 32)
    np.testing.assert_array_equal(got.numpy(), want)
    assert type(init_cache(tm.cfg, 1, 8, "cpu")[0]) is BF16KVCache
    engine = Engine(tm, EngineConfig(max_batch_size=2, max_seq_len=32, prefill_chunk=16,
                                     max_new_tokens=12), kv_dtype=torch.bfloat16)
    assert _engine_outputs(engine, [list(map(int, p)) for p in prompt]) == want.tolist()
