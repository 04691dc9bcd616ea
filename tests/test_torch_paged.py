"""The port's paged int8 KV serving path against the JAX package's.

Page allocator (the port's own g++ build), the paged decode scatter and
paged decode attention (plain versions on the CPU, against the Pallas
kernels in interpret mode), ``PagedInt8KVCache``, ``PrefixCache`` and the
paged engine with and without prefix caching, on the same numpy inputs and
the same weights (``params_from_numpy``).

Tolerances: the scatter and the cache's pools, table and lengths are exact.
Attention is held to ATOL, as the dense attention in ``test_torch_ops.py``:
both sides sum in f32 in different orders. The engines emit the same greedy
tokens.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from protoquant_tpu.engine import Engine as JEngine
from protoquant_tpu.engine import EngineConfig as JEngineConfig
from protoquant_tpu.engine.paged_kv import PagedInt8KVCache as JPagedCache
from protoquant_tpu.engine.prefix_cache import PrefixCache as JPrefixCache
from protoquant_tpu.models import LlamaModel as JLlamaModel
from protoquant_tpu.native import PageAllocator as JPageAllocator
from protoquant_tpu.ops.kv_scatter import paged_kv_scatter_decode as j_paged_scatter
from protoquant_tpu.ops.paged_attention import paged_int8_attention as j_paged_attention
from protoquant_tpu.utils.config import ModelConfig as JModelConfig
from protoquant_tpu_torch import (Engine, EngineConfig, LlamaModel, ModelConfig, native,
                                  ops, params_from_numpy)
from protoquant_tpu_torch.engine import PagedInt8KVCache, PrefixCache
from protoquant_tpu_torch.native import PageAllocator
from test_torch_model import DIMS, to_numpy_tree

ATOL = 2e-5  # attention outputs, f32 on both sides


def _np_pools(rng, P, KV, ps, Dh):
    kq = rng.integers(-127, 128, (P, KV, ps, Dh)).astype(np.int8)
    vq = rng.integers(-127, 128, (P, KV, ps, Dh)).astype(np.int8)
    ks = rng.uniform(1e-3, 2e-2, (P, KV, 1, ps)).astype(np.float32)
    vs = rng.uniform(1e-3, 2e-2, (P, KV, 1, ps)).astype(np.float32)
    return [kq, ks, vq, vs]


def _np_table(rng, B, maxP, P):
    """Shuffled page chains over pages 0 .. P - 2; row 1 unmapped."""
    pt = rng.permutation(P - 1)[:B * maxP].reshape(B, maxP).astype(np.int32)
    pt[1] = -1
    return pt


# -- the page allocator ---------------------------------------------------------


def test_page_allocator_basic():
    a = PageAllocator(8)
    assert a.num_free == 8
    p = a.alloc(5)
    assert len(p) == 5 and len(set(p)) == 5 and a.num_free == 3
    assert a.alloc(4) is None  # all-or-nothing
    assert a.num_free == 3
    a.free(p)
    assert a.num_free == 8


def test_page_allocator_double_free_guarded():
    a = PageAllocator(4)
    p = a.alloc(2)
    a.free(p)
    a.free(p)  # must not corrupt the free list
    assert a.num_free == 4
    assert sorted(a.alloc(4)) == list(range(4))


def test_page_allocator_same_ids_as_jax():
    a, j = PageAllocator(6), JPageAllocator(6)
    for n, back in ((2, False), (3, True), (4, False), (1, True)):
        pa, pj = a.alloc(n), j.alloc(n)
        assert pa == pj
        if back:
            a.free(pa[:1])
            j.free(pj[:1])
    assert a.num_free == j.num_free


def test_allocator_build_failure_raises(tmp_path, monkeypatch):
    bad = tmp_path / "pq_alloc.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        PageAllocator(4)


def test_allocator_abi_mismatch_raises(monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "ABI_VERSION", native.ABI_VERSION + 1)
    with pytest.raises(RuntimeError, match="ABI"):
        PageAllocator(4)


# -- the paged decode scatter and attention ---------------------------------------


@pytest.mark.parametrize("ps,head_dim", [(8, 32), (16, 64)])
def test_paged_scatter_exact_vs_pallas(ps, head_dim):
    rng = np.random.default_rng(ps)
    B, KV, maxP = 4, 2, 3
    P = B * maxP + 2
    pools = _np_pools(rng, P, KV, ps, head_dim)
    pt = _np_table(rng, B, maxP, P)
    # a page boundary, an unmapped row, a row past the window (trash page at
    # another offset than the unmapped row), a row inside a page
    lengths = np.array([ps, 3, maxP * ps + 5, 2 * ps + 1], np.int32)
    k8 = rng.integers(-127, 128, (B, KV, 1, head_dim)).astype(np.int8)
    v8 = rng.integers(-127, 128, (B, KV, 1, head_dim)).astype(np.int8)
    ksn = rng.uniform(1e-3, 2e-2, (B, KV, 1)).astype(np.float32)
    vsn = rng.uniform(1e-3, 2e-2, (B, KV, 1)).astype(np.float32)
    rest = [pt, lengths, k8, ksn, v8, vsn]
    want = j_paged_scatter(*map(jnp.asarray, pools + rest), interpret=True)
    t = [torch.from_numpy(a.copy()) for a in pools]
    got = ops.paged_kv_scatter_decode(*t, *map(torch.from_numpy, rest))
    # Live pages exactly. On the trash page the interpret-mode kernel keeps
    # only the last row's write when two rows land in one 8-row block (each
    # grid step writes back the whole block it read from the input), so it
    # is compared at the later row's offset only.
    for w, g, at in zip(want, got, ((P - 1, slice(None), 5), (P - 1, slice(None), 0, 5)) * 2):
        w, g = np.asarray(w), g.numpy()
        np.testing.assert_array_equal(w[:P - 1], g[:P - 1])
        np.testing.assert_array_equal(w[at], g[at])
    assert got[0].data_ptr() == t[0].data_ptr()  # in place
    np.testing.assert_array_equal(got[0][P - 1, :, 3].numpy(), k8[1, :, 0])  # unmapped
    np.testing.assert_array_equal(got[2][P - 1, :, 5].numpy(), v8[2, :, 0])  # past window
    np.testing.assert_array_equal(got[0][pt[0, 1], :, 0].numpy(), k8[0, :, 0])


@pytest.mark.parametrize("group", [1, 2])
@pytest.mark.parametrize("ps", [8, 16])
def test_paged_attention_vs_pallas(group, ps):
    rng = np.random.default_rng(10 * group + ps)
    B, KV, maxP, Dh = 4, 2, 4, 32
    P = B * maxP + 2
    pools = _np_pools(rng, P, KV, ps, Dh)
    pt = _np_table(rng, B, maxP, P)
    # the last key of a page, an unmapped row (reads page 0), the first key
    # of the next page, a full table
    lengths = np.array([ps - 1, 0, ps, maxP * ps - 1], np.int32)
    q = rng.standard_normal((B, 1, KV * group, Dh)).astype(np.float32)
    args = [q] + pools + [pt, lengths]
    want = np.asarray(j_paged_attention(*map(jnp.asarray, args), interpret=True))
    got = ops.paged_int8_attention(*map(torch.from_numpy, args)).numpy()
    assert got.shape == (B, 1, KV * group, Dh)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_paged_attention_alibi_not_ported_raises():
    """Once a raise of the unported variant, now its parity test: ALiBi in
    the page walk, slope_h * (length - position) off each score, against the
    Pallas kernel in interpret mode (the cases of
    test_paged_attention_vs_pallas, group 2, 16-token pages)."""
    from protoquant_tpu.models.llama import alibi_slopes

    rng = np.random.default_rng(12)
    B, KV, maxP, Dh, ps, group = 4, 2, 4, 32, 16, 2
    P = B * maxP + 2
    pools = _np_pools(rng, P, KV, ps, Dh)
    pt = _np_table(rng, B, maxP, P)
    lengths = np.array([ps - 1, 0, ps, maxP * ps - 1], np.int32)
    q = rng.standard_normal((B, 1, KV * group, Dh)).astype(np.float32)
    slopes = np.asarray(alibi_slopes(KV * group))
    args = [q] + pools + [pt, lengths]
    want = np.asarray(j_paged_attention(*map(jnp.asarray, args), interpret=True,
                                        alibi_slopes=jnp.asarray(slopes)))
    targs = list(map(torch.from_numpy, args))
    got = ops.paged_int8_attention(*targs, alibi_slopes=torch.from_numpy(slopes)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert np.abs(got - ops.paged_int8_attention(*targs).numpy()).max() > 1e-3


# -- PagedInt8KVCache ---------------------------------------------------------------


def test_paged_cache_matches_jax_cache():
    """The same prefill / decode / padded-chunk / retire sequence through
    both caches: equal pools (trash page included), table and lengths, and
    attention outputs within ATOL at every step."""
    rng = np.random.default_rng(20)
    B, KV, H, Dh, ps, maxP = 2, 2, 4, 32, 8, 4
    P = B * maxP + 1
    jc = JPagedCache.init(B, P, maxP, ps, KV, Dh)
    tc = PagedInt8KVCache.init(B, P, maxP, ps, KV, Dh, device="cpu")
    chains = {0: [5, 2, 7], 1: [0, 3, 6, 1]}
    for slot, pages in chains.items():
        jc = jc.map_slot(slot, pages)
        tc.map_slot(slot, pages)

    def step(jc, T, advance=None, slot=None):
        b = 1 if slot is not None else B
        q, k, v = (rng.standard_normal((b, T, h, Dh)).astype(np.float32)
                   for h in (H, KV, KV))
        adv = None if advance is None else np.asarray(advance, np.int32)
        jsub = jc if slot is None else jc.slot_view(slot)
        tsub = tc if slot is None else tc.slot_view(slot)
        # eager, not jitted: under jit XLA multiplies by 1/127 where the
        # quantizer divides, and the scales would sit an ulp off
        jout, jsub = jsub.update_and_attend(*map(jnp.asarray, (q, k, v, adv)))
        tout = tsub.update_and_attend(*map(torch.from_numpy, (q, k, v)),
                                      None if adv is None else torch.from_numpy(adv))
        if slot is not None:
            jc = jc.merge_slot(jsub, slot)
            tc.merge_slot(tsub, slot)
        else:
            jc = jsub
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=ATOL, rtol=0)
        return jc

    def same(jc):
        for f in ("kq", "ks", "vq", "vs", "page_table", "lengths"):
            np.testing.assert_array_equal(getattr(tc, f).numpy(), np.asarray(getattr(jc, f)), f)

    jc = step(jc, 12, advance=[12, 9])  # prefill; row 1 leaves 3 pad rows
    same(jc)
    for _ in range(3):  # decode; row 1 overwrites its pad rows
        jc = step(jc, 1, advance=[1, 1])
    same(jc)
    # a padded chunk of 24 rows on slot 1 from 12: positions 32..35 lie past
    # the 32-token window and go to the trash page
    jc = step(jc, 24, advance=[20], slot=1)
    same(jc)
    assert tc.lengths.tolist() == [15, 32]
    jc = jc.reset_slot(1)
    tc.reset_slot(1)
    jc = step(jc, 1, advance=[1, 0])  # the idle row writes to the trash page
    same(jc)
    assert tc.page_table[1].tolist() == [-1] * maxP


# -- PrefixCache ------------------------------------------------------------------


def _prefix_script(pc_cls, alloc_cls):
    """match / publish / unref / evict, logging every observable."""
    alloc = alloc_cls(12)
    pc = pc_cls(alloc)
    ps, log = 8, []

    def state():
        return (dict(pc.refs), list(pc.lru), sorted(pc.page_by_key.values()),
                pc.evictions, alloc.num_free, pc.cached_pages, pc.reusable_pages)

    def admit(prompt, total_pages):
        shared, matched = pc.match(prompt, ps)
        pages = pc.alloc(total_pages - len(shared))
        held = pc.publish(prompt, shared + pages, ps, len(shared))
        log.append((shared, matched, pages, held, state()))
        return pages, held

    def retire(pages, held):
        pc.unref(held)
        alloc.free([p for p in pages if p not in set(held)])
        log.append(state())

    a = admit(list(range(1, 30)), 4)  # 3 full pages published
    b = admit(list(range(1, 21)) + [99] * 10, 4)  # shares 2 pages
    c = admit(list(range(1, 17)), 2)  # page-aligned: adopts (16-1)//8 = 1 page
    retire(*a)
    retire(*c)
    d = admit(list(range(50, 90)), 8)  # pressure: evicts zero-ref pages, oldest first
    retire(*b)
    retire(*d)
    log.append(pc.alloc(13))  # more than the pool: None after evicting everything
    log.append(state())
    return log


def test_prefix_cache_matches_jax():
    assert _prefix_script(PrefixCache, PageAllocator) == _prefix_script(
        JPrefixCache, JPageAllocator)


# -- the paged engine -------------------------------------------------------------

PS = 8
SYSTEM = list(map(int, np.random.default_rng(30).integers(1, DIMS["vocab_size"], 16)))
SUFFIXES = [5, 12, 3, 20]


def _prompts():
    rng = np.random.default_rng(31)
    return [SYSTEM + list(map(int, rng.integers(1, DIMS["vocab_size"], n)))
            for n in SUFFIXES]


def _config(cls, prefix, **kw):
    base = dict(max_batch_size=2, max_seq_len=64, page_size=PS, prefill_chunk=16,
                max_new_tokens=5, prefix_cache=prefix)
    base.update(kw)
    return cls(**base)


def _serve(engine, prompts):
    """Request 0 alone until its prefill ends (so its prompt is published),
    then the others."""
    rids = [engine.add_request(prompts[0])]
    while engine.prefilling or engine.waiting:
        engine.step()
    rids += [engine.add_request(p) for p in prompts[1:]]
    out = engine.run()
    return [out[r] for r in rids], engine.metrics()


@pytest.fixture(scope="module")
def served():
    """A weight_only model on both sides, and the JAX engine's runs with and
    without the prefix cache."""
    jm = JLlamaModel(JModelConfig(**DIMS), mode="weight_only", dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(11), jnp.zeros((1, 4), jnp.int32))
    tm = LlamaModel(ModelConfig(**DIMS), mode="weight_only", dtype=torch.float32,
                    device="cpu")
    tm.load_state_dict(params_from_numpy(to_numpy_tree(params)), strict=True)
    runs = {prefix: _serve(JEngine(jm, params, _config(JEngineConfig, prefix),
                                   kv_dtype=jnp.int8, kv_layout="paged"), _prompts())
            for prefix in (False, True)}
    return tm, runs


def test_paged_engine_matches_jax_engine(served):
    tm, runs = served
    e = Engine(tm, _config(EngineConfig, False), kv_layout="paged")
    got, m = _serve(e, _prompts())
    assert got == runs[False][0]
    assert all(len(o) == 5 for o in got)
    assert m["kv_pages_free"] == m["kv_pages_total"] == 2 * 64 // PS
    assert "prefix_hit_tokens" not in m
    assert e.caches[0].kq.shape[0] == m["kv_pages_total"] + 1  # + the trash page


def test_prefix_engine_matches_jax_engine_and_recompute(served):
    tm, runs = served
    e = Engine(tm, _config(EngineConfig, True), kv_layout="paged")
    got, m = _serve(e, _prompts())
    want, jm = runs[True]
    assert got == want
    assert got == runs[False][0]  # a prefix hit equals recomputation
    assert m["prefix_hit_tokens"] == jm["prefix_hit_tokens"] == 16 * (len(SUFFIXES) - 1)
    for key in ("kv_pages_free", "kv_pages_total", "prefix_cached_pages",
                "prefix_reusable_pages", "prefix_evictions"):
        assert m[key] == jm[key], key
    assert not e.prefix.refs  # nothing live after the drain
    assert m["kv_pages_free"] + m["prefix_reusable_pages"] == m["kv_pages_total"]


def test_paged_engine_pool_exhaustion_queues(served):
    tm, _ = served
    cfg = EngineConfig(max_batch_size=4, max_seq_len=32, page_size=16, prefill_chunk=16,
                       max_new_tokens=4)
    e = Engine(tm, cfg, kv_layout="paged")
    # pool = 4 * 32 / 16 = 8 pages and each request needs one; hold 7 of
    # them outside the engine so only one request fits although 4 slots are
    # free
    stolen = e.allocator.alloc(7)
    prompts = [[1, 2, 3], [4, 5, 6, 7], [8, 9]]
    rids = [e.add_request(p) for p in prompts]
    e.step()
    assert sum(r is not None for r in e.slot_req) == 1 and len(e.waiting) == 2
    outs = e.run()
    ref = Engine(tm, cfg, kv_layout="paged")
    ref_rids = [ref.add_request(p) for p in prompts]
    ref_outs = ref.run()
    assert [outs[r] for r in rids] == [ref_outs[r] for r in ref_rids]
    e.allocator.free(stolen)
    assert e.metrics()["kv_pages_free"] == 8


def test_engine_rejects_bad_layouts(served):
    tm, _ = served
    with pytest.raises(ValueError, match="paged"):
        Engine(tm, EngineConfig(max_batch_size=2, max_seq_len=64, prefix_cache=True),
               kv_layout="dense")
    with pytest.raises(ValueError, match="multiple of page_size"):
        Engine(tm, EngineConfig(max_batch_size=2, max_seq_len=60, page_size=16),
               kv_layout="paged")
    with pytest.raises(ValueError, match="kv_layout"):
        Engine(tm, EngineConfig(max_batch_size=2, max_seq_len=64), kv_layout="ring")
