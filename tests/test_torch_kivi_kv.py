"""The port's KIVI capacity tiers (``K4V8KVCache``, ``Int4KVCache``) against
the JAX package's.

The chunk requantizer, the prefill update, both decode writers (plain
versions, against ``*_decode_update(interpret=True)`` and the JAX caches'
``_xla_update``) and the caches' state are held bit for bit: both sides
quantize with the same arithmetic (a multiply by the f32 constant 1/7, a
division by a tensor, round half to even). The JAX caches run eagerly,
because under ``jit`` XLA:CPU multiplies by 1/127 where the int8 quantizer
divides. Attention is held to 3e-5 (rtol and atol), the JAX test's own limit
for its kernel against ``dequant_fp`` + the XLA formulation: both sum in f32
in different orders. The models and engines emit the same greedy tokens.
Where a test needs chunk boundaries at small sizes it sets INT4_KV_GROUP
to 16 in both packages.
"""

import importlib

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
from protoquant_tpu.ops.attention import k4v8_attention as j_k4v8_attention
from protoquant_tpu.ops.kv_scatter import k4v8_decode_update as j_k4v8_update
from protoquant_tpu.ops.kv_scatter import kivi4_decode_update as j_kivi4_update
from protoquant_tpu.utils.config import ModelConfig as JModelConfig
from protoquant_tpu_torch import (Engine, EngineConfig, LlamaModel, ModelConfig,
                                  greedy_generate, ops, params_from_numpy)
from protoquant_tpu_torch.core import numerics
from protoquant_tpu_torch.models import (Int4KVCache, K4V8KVCache, cache_from_numpy,
                                         init_cache)
from protoquant_tpu_torch.models import kv_cache as tkv
from test_torch_model import DIMS, to_numpy_tree

TOL = 3e-5
FIELDS = ("kq", "kchs", "vq", "vs", "ktail", "kts", "vtail", "vts", "lengths")
# port class, JAX class, port writer (plain), JAX writer, port / JAX attention
TIERS = {
    "k4v8": (K4V8KVCache, jkv.K4V8KVCache, ops.k4v8_decode_update_ref, j_k4v8_update,
             ops.k4v8_attention_ref, j_k4v8_attention),
    "int4": (Int4KVCache, jkv.Int4KVCache, ops.kivi4_decode_update_ref, j_kivi4_update,
             ops.int4_kv_attention_ref, j_int4_attention),
}
B, KV, H, DH, S, G = 2, 2, 4, 16, 64, 16


def _port(jc, tier):
    """The port cache holding the JAX cache's state."""
    cls = TIERS[tier][0]
    return cache_from_numpy(cls, {f: np.asarray(getattr(jc, f)) for f in FIELDS},
                            group=jc.group, device="cpu")


TAILS = ("ktail", "kts", "vtail", "vts")


def _same(tc, jc, tail_rows=slice(None)):
    """Every field equal; the tails only in batch rows ``tail_rows``."""
    for f in FIELDS:
        rows = tail_rows if f in TAILS else slice(None)
        np.testing.assert_array_equal(getattr(tc, f).numpy()[rows],
                                      np.asarray(getattr(jc, f))[rows], err_msg=f)


def _clone(c):
    return type(c)(*(getattr(c, f).clone() for f in FIELDS), group=c.group)


def test_kivi_chunk_quantize_bitwise():
    rng = np.random.default_rng(0)
    k8 = rng.integers(-127, 128, (2, 3, 16, 32)).astype(np.int8)
    v8 = rng.integers(-127, 128, (2, 3, 16, 32)).astype(np.int8)
    ks = rng.uniform(1e-4, 3e-2, (2, 3, 16)).astype(np.float32)
    vs = rng.uniform(1e-4, 3e-2, (2, 3, 16)).astype(np.float32)
    k8[0, 0, :, 5] = 0  # an all-zero channel: the scale floor
    v8[1, 2, 7] = 0  # an all-zero token
    want = jkv.kivi_chunk_quantize(*map(jnp.asarray, (k8, ks, v8, vs)))
    got = numerics.kivi_chunk_quantize(*map(torch.from_numpy, (k8, ks, v8, vs)))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[1][0, 0, 5].item() == np.float32(numerics.SCALE_EPS)
    lo, hi = numerics.unpack_nib_pair(got[0])
    assert lo.abs().max() <= 7 and hi.abs().max() <= 7
    assert torch.equal(numerics.pack_nib_pair(lo, hi), got[0])


@pytest.mark.parametrize("tier", TIERS)
def test_cache_updates_match_jax(tier):
    """A sequence of prefills and decodes through both caches'
    ``update_and_attend``: every field equal after each step, outputs within
    TOL. It crosses chunk boundaries, pads a chunk (advance < T), idles a
    row (advance 0) and writes past S."""
    cls, jcls = TIERS[tier][:2]
    rng = np.random.default_rng(1)
    jc = jcls.init(B, S, KV, DH, group=G)
    tc = cls.init(B, S, KV, DH, group=G, device="cpu")

    def step(jc, T, advance=None, tail_rows=slice(None)):
        q, k, v = (rng.standard_normal((B, T, h, DH)).astype(np.float32) for h in (H, KV, KV))
        adv = None if advance is None else np.asarray(advance, np.int32)
        jout, jc = jc.update_and_attend(*map(jnp.asarray, (q, k, v)),
                                        None if adv is None else jnp.asarray(adv))
        tout = tc.update_and_attend(*map(torch.from_numpy, (q, k, v)),
                                    None if adv is None else torch.from_numpy(adv))
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=TOL, atol=TOL)
        _same(tc, jc, tail_rows)
        return jc

    jc = step(jc, 37)  # two chunks flushed in one prefill
    jc = step(jc, 20, advance=[9, 20])  # padded: row 0 keeps 9 of 20
    for adv in ([1, 1], [1, 0], [1, 1]):  # decode; row 1 idles once
        jc = step(jc, 1, advance=adv)
    jc = step(jc, 16, advance=[16, 2])  # row 0 passes S = 64
    jc = step(jc, 12, advance=[12, 1])  # row 0's writes drop, its length keeps counting
    # a decode step at capacity: on the CPU the JAX cache runs its XLA
    # update, which writes row 0's tail at position 76 too; the decode
    # writers (the JAX Pallas one and the port's) drop it, and no query
    # reads a tail row at or past S
    jc = step(jc, 1, tail_rows=[1])
    assert tc.lengths.tolist() == [78, 63]


@pytest.mark.parametrize("tier", TIERS)
def test_prefill_equals_decode_bitwise(tier):
    cls = TIERS[tier][0]
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((B, 37, KV, DH))
                         .astype(np.float32))
    c1 = cls.init(B, S, KV, DH, group=G, device="cpu").update(x, x)
    c2 = cls.init(B, S, KV, DH, group=G, device="cpu")
    for t in range(x.shape[1]):
        c2.update(x[:, t:t + 1], x[:, t:t + 1])
    for f in FIELDS:
        assert torch.equal(getattr(c1, f), getattr(c2, f)), f


@pytest.mark.parametrize("adv", [[1, 1], [1, 0]])
@pytest.mark.parametrize("fill", [0, 14, 15, 16, 31, S])
@pytest.mark.parametrize("tier", TIERS)
def test_decode_writer_matches_jax(tier, fill, adv):
    """The plain decode writer against the JAX writer in interpret mode and
    against the JAX cache's ``_xla_update``. At capacity the XLA update
    still writes the tails (row S mod 2G), the writers do not; nothing
    reads a tail row at or past S."""
    cls, jcls, writer, j_writer = TIERS[tier][:4]
    rng = np.random.default_rng(3 + fill)
    jc = jcls.init(B, S, KV, DH, group=G)
    if fill:
        x = jnp.asarray(rng.standard_normal((B, fill, KV, DH)), jnp.float32)
        jc = jc.update(x, x)
    new = [rng.integers(-127, 128, (B, 1, KV, DH)).astype(np.int8),
           rng.uniform(1e-3, 3e-2, (B, 1, KV)).astype(np.float32),
           rng.integers(-127, 128, (B, 1, KV, DH)).astype(np.int8),
           rng.uniform(1e-3, 3e-2, (B, 1, KV)).astype(np.float32)]
    adv = np.asarray(adv, np.int32)
    swapped = [np.swapaxes(a, 1, 2).copy() for a in new]  # [B, KV, 1, ...]
    want = j_writer(*(getattr(jc, f) for f in FIELDS), *map(jnp.asarray, swapped),
                    group=G, adv=jnp.asarray(adv), interpret=True)
    xla = jc._xla_update(*map(jnp.asarray, new), jnp.asarray(adv))
    tc = _port(jc, tier)
    got = writer(*(getattr(tc, f) for f in FIELDS), *map(torch.from_numpy, swapped),
                 group=G, adv=torch.from_numpy(adv))
    for name, w, g, x in zip(FIELDS, want, got, (getattr(xla, f) for f in FIELDS)):
        assert g.data_ptr() == getattr(tc, name).data_ptr()  # in place
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
        if fill < S or name not in ("ktail", "kts", "vtail", "vts"):
            np.testing.assert_array_equal(g.numpy(), np.asarray(x), err_msg=name)


@pytest.mark.parametrize("tier", TIERS)
def test_rollback_across_flush_boundary(tier):
    """Rewind ``lengths`` after a speculative window crossed a chunk
    boundary: the next steps equal those of a cache that never saw the
    rejected tokens (the tail rows persist; the chunk flushes again)."""
    cls = TIERS[tier][0]
    rng = np.random.default_rng(4)
    t = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    x, spec, good, q = t(1, 14, KV, DH), t(1, 4, KV, DH), t(1, 4, KV, DH), t(1, 1, H, DH)
    base = cls.init(1, S, KV, DH, group=G, device="cpu").update(x, x)
    c_a, c_b = _clone(base), _clone(base)
    c_a.update(spec, spec)  # length 18: chunk 0 flushed with the rejected tokens
    c_a.lengths.copy_(base.lengths)
    for i in range(4):
        out_a = c_a.update_and_attend(q, good[:, i:i + 1], good[:, i:i + 1])
        out_b = c_b.update_and_attend(q, good[:, i:i + 1], good[:, i:i + 1])
        np.testing.assert_allclose(out_a.numpy(), out_b.numpy(), rtol=1e-6, atol=1e-6)
    for f in ("kq", "kchs", "vq", "vs", "lengths"):
        assert torch.equal(getattr(c_a, f), getattr(c_b, f)), f


@pytest.mark.parametrize("T", [1, 4])
@pytest.mark.parametrize("tier", TIERS)
def test_attention_plain_vs_pallas(tier, T):
    """The plain attention against the JAX kernel in interpret mode (f32
    lanes), GQA H = 4 over KV = 2, the step crossing a chunk boundary."""
    jcls, ref, j_attn = TIERS[tier][1], TIERS[tier][4], TIERS[tier][5]
    rng = np.random.default_rng(5 + T)
    x = jnp.asarray(rng.standard_normal((B, 30 + T, KV, DH)), jnp.float32)
    jc = jcls.init(B, S, KV, DH, group=G).update(x[:, :30], x[:, :30])
    lengths = jc.lengths
    jc = jc.update(x[:, 30:], x[:, 30:])
    q = rng.standard_normal((B, T, H, DH)).astype(np.float32)
    arrays = [getattr(jc, f) for f in FIELDS[:-1]]
    want = np.asarray(j_attn(jnp.asarray(q), *arrays, lengths, jc.lengths, group=G,
                             interpret=True))
    tc = _port(jc, tier)
    got = ref(torch.from_numpy(q), *(getattr(tc, f) for f in FIELDS[:-1]),
              torch.from_numpy(np.array(lengths)), tc.lengths, group=G)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    # the wrapper takes the plain version on the CPU and counts nothing
    ops.reset_launch_counts()
    wrapper = ops.k4v8_attention if tier == "k4v8" else ops.int4_kv_attention
    assert torch.equal(wrapper(torch.from_numpy(q), *(getattr(tc, f) for f in FIELDS[:-1]),
                               torch.from_numpy(np.array(lengths)), tc.lengths, group=G), got)
    assert not any(ops.launch_counts().values())


@pytest.mark.parametrize("tier", TIERS)
def test_attention_variants_not_ported_raise(tier):
    cls, attn = TIERS[tier][0], (ops.k4v8_attention if tier == "k4v8" else ops.int4_kv_attention)
    c = cls.init(1, 16, 1, 16, group=8, device="cpu")
    q = torch.zeros(1, 1, 2, 16)
    for kw in ({"tree_mask": torch.ones(1, 1)},):
        with pytest.raises(NotImplementedError):
            attn(q, *(getattr(c, f) for f in FIELDS), c.lengths, group=8, **kw)


def test_cache_init_checks_and_group_global(monkeypatch):
    with pytest.raises(ValueError, match="max_seq % group"):
        K4V8KVCache.init(1, 48, 1, 16, group=32, device="cpu")
    with pytest.raises(ValueError, match="even"):
        Int4KVCache.init(1, 45, 1, 16, group=45, device="cpu")
    assert Int4KVCache.init(1, 32, 1, 16, device="cpu").group == 32  # min(64, max_seq)
    monkeypatch.setattr(tkv, "INT4_KV_GROUP", 8)
    c = K4V8KVCache.init(2, 32, 3, 16, device="cpu")
    assert c.group == 8 and c.max_seq == 32
    assert c.kq.shape == (2, 3, 16, 16) and c.kchs.shape == (2, 3, 4, 16)
    assert c.vq.shape == (2, 3, 32, 16) and c.ktail.shape == (2, 3, 16, 16)
    c4 = Int4KVCache.init(2, 32, 3, 16, device="cpu")
    assert c4.vq.shape == (2, 3, 16, 16) and c4.vs.shape == (2, 3, 2, 16)
    view = c4.slot_view(1)
    view.update(torch.ones(1, 9, 3, 16), torch.ones(1, 9, 3, 16))
    assert c4.lengths.tolist() == [0, 9] and c4.kq[1].any() and not c4.kq[0].any()
    c4.reset_slot(1)
    assert c4.lengths.tolist() == [0, 0]


def test_init_cache_kv_dtypes():
    cfg = ModelConfig(**DIMS)
    for kv_dtype, cls in (("int8", tkv.Int8KVCache), (torch.int8, tkv.Int8KVCache),
                          ("k4v8", K4V8KVCache), ("int4", Int4KVCache),
                          ("k8v4", tkv.MixedKVCache), ("bf16", tkv.BF16KVCache),
                          (torch.bfloat16, tkv.BF16KVCache), (torch.float32, tkv.BF16KVCache)):
        caches = init_cache(cfg, 2, 64, device="cpu", kv_dtype=kv_dtype)
        assert len(caches) == 2 and all(type(c) is cls for c in caches)
    assert init_cache(cfg, 2, 64, device="cpu", kv_dtype=torch.float32)[0].k.dtype == torch.float32
    assert init_cache(cfg, 2, 64, device="cpu")[0].k.dtype == torch.bfloat16  # the default
    for bad in ("fp8", "f32", torch.float16, None):
        with pytest.raises(ValueError, match="kv_dtype"):
            init_cache(cfg, 2, 64, device="cpu", kv_dtype=bad)


# -- the model and the engine ------------------------------------------------------

KIVI_DIMS = dict(DIMS, vocab_size=76)  # a config of its own: no JAX trace reused
JAX_KV = {"k4v8": "k4v8", "int4": jnp.int4}


@pytest.fixture(scope="module")
def kivi_pair():
    jm = JLlamaModel(JModelConfig(**KIVI_DIMS), mode="dynamic", dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(7), jnp.zeros((1, 4), jnp.int32))
    tm = LlamaModel(ModelConfig(**KIVI_DIMS), mode="dynamic", dtype=torch.float32,
                    device="cpu")
    tm.load_state_dict(params_from_numpy(to_numpy_tree(params)), strict=True)
    return jm, params, tm


@pytest.fixture
def group16(monkeypatch):
    monkeypatch.setattr(jkv, "INT4_KV_GROUP", G)
    monkeypatch.setattr(tkv, "INT4_KV_GROUP", G)


def _j_greedy_eager(jm, params, prompt, steps, kv_dtype):
    """The JAX model's greedy decode, one eager ``apply`` per step: under
    ``jit`` XLA:CPU quantizes K/V with a reciprocal multiply, and over an
    int4 cache one scale an ulp off can flip a near-tied argmax."""
    caches = j_init_cache(jm.cfg, prompt.shape[0], 64, kv_dtype=kv_dtype)
    logits, caches = jm.apply(params, jnp.asarray(prompt), None, caches)
    out = []
    for _ in range(steps):
        tok = np.asarray(logits)[:, -1].argmax(-1).astype(np.int32)[:, None]
        out.append(tok[:, 0])
        pos = np.asarray(caches[0].lengths)[:, None]
        logits, caches = jm.apply(params, jnp.asarray(tok), jnp.asarray(pos), caches)
    return np.stack(out, axis=1)


@pytest.mark.parametrize("tier", TIERS)
def test_greedy_tokens_identical(kivi_pair, group16, tier):
    jm, params, tm = kivi_pair
    prompt = np.random.default_rng(8).integers(1, KIVI_DIMS["vocab_size"], (2, 13)).astype(
        np.int32)
    want = _j_greedy_eager(jm, params, prompt, 20, JAX_KV[tier])
    got = greedy_generate(tm, torch.from_numpy(prompt), 20, max_seq=64, kv_dtype=tier)
    np.testing.assert_array_equal(got.numpy(), want)


def _engine_outputs(engine, prompts):
    rids = [engine.add_request(p) for p in prompts]
    out = engine.run()
    return [out[r] for r in rids]


@pytest.mark.parametrize("tier", TIERS)
def test_engine_matches_jax_engine(kivi_pair, group16, tier):
    jm, params, tm = kivi_pair
    rng = np.random.default_rng(9)
    prompts = [list(map(int, rng.integers(1, KIVI_DIMS["vocab_size"], n)))
               for n in (5, 20, 33)]
    kw = dict(max_batch_size=2, max_seq_len=64, prefill_chunk=16, max_new_tokens=9)
    want = _engine_outputs(JEngine(jm, params, JEngineConfig(**kw), kv_dtype=JAX_KV[tier]),
                           prompts)
    engine = Engine(tm, EngineConfig(**kw), kv_dtype=tier)
    assert type(engine.caches[0]) is TIERS[tier][0] and engine.caches[0].group == G
    assert _engine_outputs(engine, prompts) == want
    assert all(len(o) == 9 for o in want)


def test_engine_guards(kivi_pair, monkeypatch):
    tm = kivi_pair[2]
    with pytest.raises(ValueError, match="tail rows"):
        Engine(tm, EngineConfig(max_batch_size=1, max_seq_len=1024, prefill_chunk=512),
               kv_dtype="k4v8")
    for chunk in (128, 256):
        Engine(tm, EngineConfig(max_batch_size=1, max_seq_len=1024, prefill_chunk=chunk),
               kv_dtype="int4")
    # pieces padded to the 16-token bucket past a small group (G = 4, 8)
    # overwrite rows of the previous piece; the safe settings are admitted,
    # the 7B one (G = 64, chunk 256) among them
    for group, chunk, refused in ((4, 8, True), (4, 16, True), (8, 12, True),
                                  (8, 16, False), (8, 32, False), (16, 24, False),
                                  (16, 64, False), (64, 256, False)):
        monkeypatch.setattr(tkv, "INT4_KV_GROUP", group)
        for tier in TIERS:
            cfg = EngineConfig(max_batch_size=1, max_seq_len=8 * chunk, prefill_chunk=chunk)
            if refused:
                with pytest.raises(ValueError, match="tail rows"):
                    Engine(tm, cfg, kv_dtype=tier)
            else:
                assert Engine(tm, cfg, kv_dtype=tier).caches[0].group == group
    monkeypatch.setattr(tkv, "INT4_KV_GROUP", 64)
    Engine(tm, EngineConfig(max_batch_size=1, max_seq_len=64, prefill_chunk=512),
           kv_dtype="k8v4")  # no tail: no chunk is refused
    with pytest.raises(ValueError, match="paged"):
        Engine(tm, EngineConfig(max_batch_size=1, max_seq_len=64, page_size=16),
               kv_layout="paged", kv_dtype="int4")
    with pytest.raises(ValueError, match="kv_dtype"):
        Engine(tm, EngineConfig(max_batch_size=1, max_seq_len=64), kv_dtype="fp8")


def test_slot_view_merge_slot_roundtrip():
    c = Int4KVCache.init(3, 32, 2, 16, group=8, device="cpu")
    small = Int4KVCache.init(1, 32, 2, 16, group=8, device="cpu")
    small.update(torch.randn(1, 11, 2, 16), torch.randn(1, 11, 2, 16))
    c.merge_slot(small, 2)
    for f in FIELDS:
        assert torch.equal(getattr(c, f)[2:3], getattr(small, f)), f


def pad_overwrite_delta(tier, T, n, seed=10):
    """max |dK|, max |dV| over the valid positions of the JAX cache between a
    prefill of ``n`` tokens padded to ``T`` (advance n) and the same prefill
    unpadded (``dequant_fp`` in f32; G = 64, S = 1024). Nonzero where pad
    rows took tail rows that valid positions still need."""
    jcls = TIERS[tier][1]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((1, T, 1, 16)).astype(np.float32)
    x[:, n:] = rng.standard_normal((1, T - n, 1, 16))  # pad rows hold other values
    padded = jcls.init(1, 1024, 1, 16, group=64).update(
        jnp.asarray(x), jnp.asarray(x), jnp.asarray([n], jnp.int32))
    exact = jcls.init(1, 1024, 1, 16, group=64).update(jnp.asarray(x[:, :n]),
                                                       jnp.asarray(x[:, :n]))
    (kp, vp), (ke, ve) = padded.dequant_fp(jnp.float32), exact.dequant_fp(jnp.float32)
    return (float(np.abs(np.asarray(kp - ke))[:, :, :n].max()),
            float(np.abs(np.asarray(vp - ve))[:, :, :n].max()))


@pytest.mark.parametrize("T,n,lost", [(256, 129, False), (256, 188, False), (512, 300, True),
                                      (512, 400, False)])
@pytest.mark.parametrize("tier", TIERS)
def test_reference_pad_overwrite(tier, T, n, lost):
    """The fault the engine guard keeps out: a padded piece longer than 4G
    can overwrite live tail rows in the JAX caches (and, bit for bit, in the
    port's). Pieces of the engine's allowed chunks never do."""
    dk, dv = pad_overwrite_delta(tier, T, n)
    assert (dk > 0) == lost
    assert dv == 0 or (tier == "int4" and lost)  # K4V8 reads V from vq


@pytest.mark.parametrize("G,chunk", [(4, 8), (4, 16), (8, 12), (8, 16), (8, 32), (16, 24)])
def test_engine_guard_matches_pad_overwrites(G, chunk):
    """The engine's guard against the port's Int4 cache (bit for bit the JAX
    one): every prompt prefilled in the engine's padded pieces is compared
    with one unpadded update over its valid positions; the guard refuses a
    chunk iff some prompt loses live tail rows."""
    from protoquant_tpu_torch.engine.engine import _bucket, kivi_pad_overwrites

    S = 16 * chunk
    rng = np.random.default_rng(G * 100 + chunk)
    lost = False
    for total in range(1, 2 * G * chunk // np.gcd(2 * G, chunk) + chunk + 1):
        x = torch.from_numpy(rng.standard_normal((1, S, 1, 16)).astype(np.float32))
        exact = Int4KVCache.init(1, S, 1, 16, group=G, device="cpu").update(
            x[:, :total], x[:, :total])
        padded = Int4KVCache.init(1, S, 1, 16, group=G, device="cpu")
        for off in range(0, total, chunk):
            n = min(chunk, total - off)
            padded.update(x[:, off:off + _bucket(n, chunk)], x[:, off:off + _bucket(n, chunk)],
                          torch.tensor([n], dtype=torch.int32))
        (kp, vp), (ke, ve) = padded.dequant_fp(), exact.dequant_fp()
        lost |= not (torch.equal(kp[:, :, :total], ke[:, :, :total])
                     and torch.equal(vp[:, :, :total], ve[:, :, :total]))
    assert lost == kivi_pad_overwrites(chunk, G)


# -- the prefill route of the KIVI updates (T > 1 new rows a slot) -----------------

KS = importlib.import_module("protoquant_tpu_torch.ops.kv_scatter")
WRITERS = {"k4v8": ops.k4v8_decode_update, "int4": ops.kivi4_decode_update}
# (G, S, lengths before, T, advance or None): a chunk flushed from old tail
# rows and new rows, T past 2G (new rows land on old tail rows), padded
# pieces (advance < T), writes past S and from a length at or past S
PREFILL_CASES = [
    (8, 64, [0, 0], 2, None), (8, 64, [3, 13], 20, None), (8, 64, [5, 10], 37, [9, 37]),
    (8, 64, [50, 60], 12, None), (8, 64, [64, 70], 5, [5, 0]), (8, 64, [7, 0], 300, [300, 3]),
    (64, 512, [0, 0], 2, None), (64, 512, [10, 100], 130, None),
    (64, 512, [300, 63], 256, [256, 100]), (64, 512, [500, 450], 300, None)]


def _filled_jax(jcls, G, S, lens, rng):
    """A JAX cache of B = 2 rows with random contents up to ``lens``: one
    update padded to the longest row, so the tails hold rows past each."""
    jc = jcls.init(2, S, KV, DH, group=G)
    top = max(lens)
    if top:
        x = jnp.asarray(rng.standard_normal((2, top, KV, DH)), jnp.float32)
        jc = jc.update(x, x * 0.5, jnp.asarray(lens, jnp.int32))
    return jc


def _new_rows(rng, T):
    """Per-token int8 rows and scales [B, T, KV, ...] as quantize_kv gives."""
    return [rng.integers(-127, 128, (2, T, KV, DH)).astype(np.int8),
            rng.uniform(1e-3, 3e-2, (2, T, KV)).astype(np.float32),
            rng.integers(-127, 128, (2, T, KV, DH)).astype(np.int8),
            rng.uniform(1e-3, 3e-2, (2, T, KV)).astype(np.float32)]


@pytest.mark.parametrize("case", range(len(PREFILL_CASES)))
@pytest.mark.parametrize("tier", TIERS)
def test_prefill_route_matches_jax_xla_update(tier, case):
    """The prefill route's plain version (through the wrapper on the CPU, the
    new rows as [B, KV, T, ...] views) against the JAX cache's
    ``_xla_update``: all eight tensors bit for bit, tails included (both
    write tail rows past S), in place."""
    G, S, lens, T, advance = PREFILL_CASES[case]
    jcls = TIERS[tier][1]
    rng = np.random.default_rng(20 + case)
    jc = _filled_jax(jcls, G, S, lens, rng)
    new = _new_rows(rng, T)
    adv = np.asarray([T, T] if advance is None else advance, np.int32)
    want = jc._xla_update(*map(jnp.asarray, new), jnp.asarray(adv))
    tc = _port(jc, tier)
    t8 = [torch.from_numpy(a).transpose(1, 2) for a in new]  # [B, KV, T, ...] views
    got = WRITERS[tier](*(getattr(tc, f) for f in FIELDS), *t8, group=G,
                        adv=None if advance is None else torch.from_numpy(adv))
    for name, g in zip(FIELDS, got):
        assert g.data_ptr() == getattr(tc, name).data_ptr()  # in place
        np.testing.assert_array_equal(g.numpy(), np.asarray(getattr(want, name)),
                                      err_msg=name)


def _old_prefill(cache, k8, ks8, v8, vs8, adv):
    """The caches' prefill write as it stood before it moved to
    ``ops.kivi_prefill_update_ref`` (``_KiviKVCache._prefill``, verbatim but
    for ``self``): k8/v8 [B, T, KV, Dh], ks8/vs8 [B, T, KV]."""
    self = cache
    B, T = k8.shape[:2]
    G, S, dev = self.group, self.max_seq, k8.device
    L_old = self.lengths.long()
    L_new = (L_old + adv.long()).clamp_max(S)
    k8t, ks8t = k8.transpose(1, 2), ks8.transpose(1, 2)
    v8t, vs8t = v8.transpose(1, 2), vs8.transpose(1, 2)
    if not self.V4:
        pos = L_old[:, None] + torch.arange(T, device=dev)[None, :]
        keep = pos < S
        bi, si = torch.arange(B, device=dev)[:, None].expand(B, T)[keep], pos[keep]
        self.vq[bi, :, si] = v8[keep]
        self.vs[bi, :, si] = vs8[keep]

    def chunk_rows(x8t, xs8t, xtail, xts, pos, use_tail):
        idx = (pos - L_old[:, None]).clamp(0, T - 1)
        row = pos % (2 * G)
        c8 = torch.where(use_tail[:, None, :, None], KS.gather_rows(xtail, row),
                         KS.gather_rows(x8t, idx))
        cs = torch.where(use_tail[:, None, :], KS.gather_rows(xts, row),
                         KS.gather_rows(xs8t, idx))
        return c8, cs

    j = torch.arange(G, device=dev)
    for f in range((G - 1 + T) // G):
        c = L_old // G + f
        flush = (c + 1) * G <= L_new
        pos = c[:, None] * G + j[None, :]
        use_tail = pos < L_old[:, None]
        packed_k, s_ch = numerics.kivi_chunk_quantize_k(
            *chunk_rows(k8t, ks8t, self.ktail, self.kts, pos, use_tail))
        rows = KS.put_chunk(self.kq, self.kchs, packed_k, s_ch, c, flush, G)
        if self.V4:
            packed_v, s_v = numerics.kivi_chunk_quantize_v(
                *chunk_rows(v8t, vs8t, self.vtail, self.vts, pos, use_tail))
            KS.put_v_chunk(self.vq, self.vs, packed_v, s_v, rows, flush)

    j2 = torch.arange(2 * G, device=dev)[None, :]
    w_last = L_old[:, None] + T - 1
    p_j = w_last - (w_last - j2) % (2 * G)
    fresh = p_j >= L_old[:, None]
    idx = (p_j - L_old[:, None]).clamp(0, T - 1)
    for tail, ts, x8t, xs8t in ((self.ktail, self.kts, k8t, ks8t),
                                (self.vtail, self.vts, v8t, vs8t)):
        tail.copy_(torch.where(fresh[:, None, :, None], KS.gather_rows(x8t, idx), tail))
        ts.copy_(torch.where(fresh[:, None, :], KS.gather_rows(xs8t, idx), ts))


@pytest.mark.parametrize("steps", [[(37, None), (20, [9, 20]), (16, [16, 2]), (12, None)],
                                   [(40, None), (40, [40, 33]), (40, None)]])
@pytest.mark.parametrize("tier", TIERS)
def test_cache_prefill_equals_old_path(tier, steps):
    """The cache's T > 1 writes through the wrapper give the eight tensors
    that its old plain ``_prefill`` gave, step after step (G = 16, S = 64:
    chunks flushed, a padded piece, pieces past 2G and past S)."""
    cls = TIERS[tier][0]
    rng = np.random.default_rng(30 + len(steps))
    new = cls.init(B, S, KV, DH, group=G, device="cpu")
    old = cls.init(B, S, KV, DH, group=G, device="cpu")
    for T, advance in steps:
        k, v = (torch.from_numpy(rng.standard_normal((B, T, KV, DH)).astype(np.float32))
                for _ in range(2))
        adv = torch.tensor([T] * B if advance is None else advance, dtype=torch.int32)
        new.update(k, v, adv)
        k8, ks8 = tkv.quantize_kv(k)
        v8, vs8 = tkv.quantize_kv(v)
        _old_prefill(old, k8, ks8, v8, vs8, adv)
        old.lengths += adv
        for f in FIELDS:
            assert torch.equal(getattr(new, f), getattr(old, f)), (T, f)


def _stub_launcher(monkeypatch):
    """The kernel library replaced by a recorder of each entry's arguments
    (operands on the meta device: no card needed)."""
    calls = []

    class Lib:
        def __getattr__(self, name):
            return lambda *args: calls.append((name, args)) or 0

    monkeypatch.setattr(KS._build, "lib", lambda verbose=False: Lib())
    monkeypatch.setattr(KS._build, "stream_ptr", lambda dev: 0)
    return calls


@pytest.mark.parametrize("tier", TIERS)
def test_update_routes_by_rows(monkeypatch, tier):
    """With the launcher stubbed: one launch a cache update, on route
    "decode" at T = 1 and "prefill" above (the C entry's last flag), each
    counted in ``.routes`` and ``ops.route_counts``, with T and the new
    rows' strides (the [B, T, KV, Dh] rows seen as [B, KV, T, Dh])."""
    calls = _stub_launcher(monkeypatch)
    cls, writer = TIERS[tier][0], WRITERS[tier]
    name = "kivi4_decode_update" if tier == "int4" else "k4v8_decode_update"
    cache = cls.init(2, 128, 4, 64, group=16, device="meta")
    for T, route in ((1, "decode"), (2, "prefill"), (16, "prefill"), (33, "prefill")):
        ops.reset_launch_counts()
        calls.clear()
        x = torch.empty(2, T, 4, 64, device="meta")
        cache.update(x, x)
        (c_name, args), = calls
        assert c_name == "pq_" + name
        B, KV, S, Dh, G, T_, xsb, xsh, xst, ssb, ssh, sst, prefill = args[14:27]
        assert (B, KV, S, Dh, G, T_, prefill) == (2, 4, 128, 64, 16, T, int(route == "prefill"))
        assert (xsb, xsh, xst) == (T * 4 * 64, 64, 4 * 64 if T > 1 else 0)
        assert (ssb, ssh, sst) == (T * 4, 1, 4 if T > 1 else 0)
        assert writer.routes == {"decode": int(route == "decode"),
                                 "prefill": int(route == "prefill")}
        counts = ops.route_counts()
        assert counts[f"{name}_{route}"] == 1 and ops.launch_counts()[name] == 1


@pytest.mark.parametrize("tier", TIERS)
def test_update_launch_rejects(monkeypatch, tier):
    """Refused before launch: a head dim the kernel does not take, new rows
    whose K and V strides differ, rows not 16-byte aligned; nothing is
    counted."""
    calls = _stub_launcher(monkeypatch)
    cls, writer = TIERS[tier][0], WRITERS[tier]
    ops.reset_launch_counts()
    for Dh, match in ((48, "head_dim"),):
        c = cls.init(1, 32, 2, Dh, group=8, device="meta")
        x8 = torch.empty(1, 2, 3, Dh, dtype=torch.int8, device="meta")
        s = torch.empty(1, 2, 3, device="meta")
        with pytest.raises(ValueError, match=match):
            writer(*(getattr(c, f) for f in FIELDS), x8, s, x8, s, group=8)
    c = cls.init(1, 32, 2, 64, group=8, device="meta")
    x8 = torch.empty(1, 3, 2, 64, dtype=torch.int8, device="meta").transpose(1, 2)
    s = torch.empty(1, 3, 2, device="meta").transpose(1, 2)
    with pytest.raises(ValueError, match="share their strides"):
        writer(*(getattr(c, f) for f in FIELDS), x8, s, x8.contiguous(), s, group=8)
    odd = torch.empty(1, 2, 3, 72, dtype=torch.int8, device="meta")[..., :64]
    with pytest.raises(ValueError, match="16-byte"):
        writer(*(getattr(c, f) for f in FIELDS), odd, s, odd, s, group=8)
    assert not calls and not any(ops.launch_counts().values())
